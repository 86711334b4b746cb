"""Hand-transcribed published line positions and band intensities:
external ground truth (counterpart of ``radtxfr_tpu/lines/golden.py``).

The derived LWIR line lists (:mod:`.derived`) are built from effective
Hamiltonians with stated uncertainties (~0.1 cm^-1 positions, ~30% band
intensities). Nothing in the repo pinned those claims to data measured
outside the repo; this module does.

**CO2 laser-band transitions** (00011 -> 10001, the 10.4 um band, and
00011 -> 10002, the 9.4 um band, in HITRAN vibrational labels where
10001 is the higher Fermi-dyad member at 1388.18 cm^-1). These are the
most precisely known infrared transition frequencies in existence —
measured by sub-Doppler heterodyne spectroscopy of the CO2 laser (C.
Freed, L. C. Bradley, R. G. O'Donnell, IEEE J. Quantum Electron. 16,
1195 (1980); reproduced in every gas-laser handbook and in HITRAN) to
1e-5 cm^-1-class accuracy. The values below are transcribed from the
standard CO2 laser frequency tables; transcription confidence is
~1e-3 cm^-1 (the table values themselves are far better), which is the
tolerance the accuracy report and tests use.

Emission P(J)/R(J) label convention: J is the LOWER-state rotational
quantum number of the *emission* line, i.e. the rotational level of the
(00011) upper vibrational state is J' = J - 1 for P(J) and J' = J + 1
for R(J)... in ABSORPTION terms (the line-list convention: J'' of the
lower vibrational state 10001/10002) the P(J)_emission line is the
R(J-1)_absorption line of the band. To stay unambiguous this table
stores each line as (band, J_lower_vib, dJ, nu) where J_lower_vib is
the rotational quantum number in the 10001/10002 state and
dJ = J(00011) - J(lower): the CO2 laser P(J) emission line has
J_lower_vib = J, dJ = -1; R(J) emission has J_lower_vib = J, dJ = +1.
"""

from __future__ import annotations

import numpy as np

__all__ = ["CO2_LASER_LINES", "co2_laser_golden", "match_golden_positions",
           "LITERATURE_BAND_INTENSITIES", "band_intensity_residuals"]

#: (band_label, J_lower_vib, dJ, nu_obs [cm^-1])
#: band_label "10um" = 00011->10001 (origin 960.959), "9um" = 00011->10002
#: (origin 1063.734). Transcribed from the CO2 laser frequency tables
#: (Freed et al. 1980 heterodyne values as tabulated in standard
#: references); ~1e-3 cm^-1 transcription confidence.
CO2_LASER_LINES = [
    # --- 10.4 um band, P branch (emission P(J): lower-vib J, dJ = -1) ---
    ("10um", 12, -1, 951.1923),
    ("10um", 14, -1, 949.4793),
    ("10um", 16, -1, 947.7417),
    ("10um", 18, -1, 945.9802),
    ("10um", 20, -1, 944.1940),   # the classic 10.59 um laser line
    ("10um", 22, -1, 942.3834),
    ("10um", 24, -1, 940.5481),
    # --- 10.4 um band, R branch (emission R(J): lower-vib J, dJ = +1;
    # 10R(20) at 975.9304 is a heterodyne frequency standard) ---
    ("10um", 10, +1, 969.1395),
    ("10um", 12, +1, 970.5472),
    ("10um", 14, +1, 971.9303),
    ("10um", 16, +1, 973.2885),
    ("10um", 18, +1, 974.6219),
    ("10um", 20, +1, 975.9304),
    # --- 9.4 um band ---
    ("9um", 20, -1, 1046.8542),   # the 9.55 um laser line
]

_BAND_STATES = {"10um": ("10001", "00011"), "9um": ("10002", "00011")}


def co2_laser_golden():
    """Golden table as arrays: (band_lower, band_upper, J, dJ, nu_obs)."""
    lo = np.array([_BAND_STATES[b][0] for b, *_ in CO2_LASER_LINES])
    hi = np.array([_BAND_STATES[b][1] for b, *_ in CO2_LASER_LINES])
    J = np.array([j for _, j, _, _ in CO2_LASER_LINES], dtype=np.int32)
    dJ = np.array([d for _, _, d, _ in CO2_LASER_LINES], dtype=np.int32)
    nu = np.array([v for *_, v in CO2_LASER_LINES], dtype=np.float64)
    return lo, hi, J, dJ, nu


def match_golden_positions(j_max: int = 60):
    """Residuals of the derived CO2 list against the golden laser lines.

    Returns (nu_obs, nu_model, labels): the golden positions, the derived
    effective-Hamiltonian positions for the same (band, J, dJ), and
    human-readable labels. Matching is by quantum numbers (band metadata
    carried by :func:`radtxfr_tpu_torch.lines.derived.co2_lwir_lines`), not by
    nearest-frequency — a position error cannot silently re-pair lines.
    """
    from .derived import co2_lwir_lines

    rows = co2_lwir_lines(nu_min=500.0, nu_max=1200.0, j_max=j_max)
    lo, hi, J, dJ, nu_obs = co2_laser_golden()
    band_tag = np.array([f"1:{a}->{b}" for a, b in zip(lo, hi)])
    nu_model = np.full(nu_obs.size, np.nan)
    for i in range(nu_obs.size):
        m = ((rows["band"] == band_tag[i]) & (rows["J"] == J[i])
             & (rows["dJ"] == dJ[i]))
        k = np.nonzero(m)[0]
        if k.size == 1:
            nu_model[i] = rows["nu0"][k[0]]
    labels = [f"{b} {'P' if d < 0 else 'R'}({j})"
              for b, j, d, _ in CO2_LASER_LINES]
    return nu_obs, nu_model, labels


# ===========================================================================
# Band-intensity anchors
# ===========================================================================

#: (label, HITRAN molecule id, (nu_lo, nu_hi) integration window [cm^-1],
#:  S_band at 296 K [cm^-1/(molec cm^-2)], fractional confidence)
#:
#: Transcribed from the infrared band-strength literature (Penner &
#: Varanasi-class laboratory band intensities as tabulated in standard
#: references; values quoted there in cm^-2 atm^-1 at 296 K converted by
#: 1/2.479e19). Honesty note: the derived lists (:mod:`.derived`)
#: *anchored their band totals to the same literature class*, so the
#: residuals below validate the list's Hoenl-London/Boltzmann
#: normalization machinery and transcription consistency against the
#: anchor — positions have genuinely independent truth (the laser tables
#: above); intensities have literature-class anchors whose stated
#: confidence (the last column) is what :mod:`tools.error_budget`
#: propagates to the end products.
LITERATURE_BAND_INTENSITIES = [
    ("CO2 15um nu2 system (fund.+hots+isotopes)", 2, (550.0, 830.0),
     9.7e-18, 0.15),     # ~240 cm^-2 atm^-1 at 296 K
    ("O3 9.6um system (nu3+nu1)", 3, (950.0, 1180.0),
     1.45e-17, 0.20),    # ~330-390 cm^-2 atm^-1
    ("N2O nu1 band", 4, (1230.0, 1330.0),
     1.0e-17, 0.20),     # ~250 cm^-2 atm^-1
]


def band_intensity_residuals():
    """Integrated derived-list intensity per anchor window vs the
    literature anchor. Returns rows of ``(label, S_model, S_anchor,
    resid_frac, confidence)`` with ``resid_frac = S_model/S_anchor - 1``
    (host float64: the list's host columns, in its sorted order).
    """
    import torch

    from .derived import derived_lwir_linelist

    store = derived_lwir_linelist(500.0, 1400.0, device="cpu",
                                  dtype=torch.float64)
    nu, sw, mol = (store.host[k] for k in ("nu0", "sw", "mol_id"))
    rows = []
    for label, m, (lo, hi), s_ref, conf in LITERATURE_BAND_INTENSITIES:
        s_mod = float(sw[(mol == m) & (nu >= lo) & (nu <= hi)].sum())
        rows.append((label, s_mod, s_ref, s_mod / s_ref - 1.0, conf))
    return rows
