"""The physics-derived LWIR line list, frozen: the input maker of the
``lwir_tud_prod`` configuration, standing in for the AER v3.6 TAPE3
database (a git-LFS stub in the reference).

A verbatim copy of ``radtxfr_tpu_torch/lines/derived.py:51-554`` (every
function but ``derived_lwir_linelist``, :534-542, which here returns the
NumPy columns instead of a line store), kept beside the benchmark so that a change to the
program's copy cannot change the benchmark's input. Rotational and
vibrational constants are published spectroscopic constants; band totals
are literature-anchored to about 30%; see the program's module for the
provenance of each table.
"""

from __future__ import annotations

import functools

import numpy as np

#: second radiation constant [cm K] and HITRAN reference temperature [K]
C2_CM_K = 1.4388028496642257
T_REF = 296.0

__all__ = ["co2_lwir_lines", "o3_lwir_lines", "h2o_lwir_lines",
           "n2o_lwir_lines", "ch4_nu4_lines", "derived_lwir_columns"]


# ---------------------------------------------------------------------------
# CO2: linear-molecule effective-constant band system
# ---------------------------------------------------------------------------

#: vibrational states of 12C16O2 (626): name -> (Gv [cm^-1], Bv [cm^-1],
#: Dv [cm^-1], l, sigma-parity). Gv/Bv are the standard effective constants
#: (Rothman & Young 1981 class values); sigma-parity 'g' means only even J
#: exist (Sigma_g+ of a symmetric molecule with spin-0 O), 'u' only odd J,
#: None = all J >= l (Pi/Delta/Phi states carry both e/f components).
_CO2_STATES_626 = {
    "00001": (0.0,      0.39021894, 1.333e-7, 0, "g"),
    "01101": (667.380,  0.39063897, 1.350e-7, 1, None),
    "02201": (1335.132, 0.39164300, 1.380e-7, 2, None),
    "10002": (1285.408, 0.39046100, 1.580e-7, 0, "g"),
    "10001": (1388.184, 0.39018893, 1.140e-7, 0, "g"),
    "03301": (2003.246, 0.39305000, 1.410e-7, 3, None),
    "11102": (1932.470, 0.39115300, 1.520e-7, 1, None),
    "11101": (2076.856, 0.39023100, 1.220e-7, 1, None),
    "00011": (2349.143, 0.38714140, 1.333e-7, 0, "u"),
}

#: LWIR band system: (lower, upper, total band intensity at 296 K
#: [cm^-1/(molec cm^-2)], including the 296 K lower-state vibrational
#: population and natural 626 abundance — the HITRAN sw convention).
#: Totals are literature-anchored (nu2 system ~240 cm^-2 atm^-1 at 296 K
#: ~ 9.7e-18 cm/molec across fundamental+hots; laser bands ~1e-20).
_CO2_BANDS_626 = [
    ("00001", "01101", 7.6e-18),    # nu2 fundamental, Q at 667.380
    ("01101", "02201", 1.05e-18),   # 1st hot, Q at 667.752
    ("02201", "03301", 8.0e-20),    # 2nd hot, Q at 668.114
    ("01101", "10001", 4.0e-19),    # Fermi-dyad difference, Q at 720.805
    ("01101", "10002", 2.8e-19),    # Q at 618.029
    ("02201", "11101", 4.5e-20),    # Q at 741.724
    ("02201", "11102", 3.0e-20),    # Q at 597.338
    ("10002", "11102", 2.2e-20),    # Q at 647.062
    ("10002", "11101", 1.4e-20),    # Q at 791.448
    ("10001", "11101", 2.0e-20),    # Q at 688.672
    ("10001", "00011", 1.0e-20),    # 10.4 um laser band (Sigma-Sigma, P/R)
    ("10002", "00011", 1.3e-20),    # 9.4 um laser band
]

#: 13C16O2 (636): nu2 at 648.478 (Q branch), scaled constants; intensity
#: carries the 0.01106 natural abundance (HITRAN convention).
_CO2_STATES_636 = {
    "00001": (0.0,     0.39023754, 1.33e-7, 0, "g"),
    "01101": (648.478, 0.39063300, 1.35e-7, 1, None),
    "02201": (1297.26, 0.39161000, 1.38e-7, 2, None),
}
_CO2_BANDS_636 = [
    ("00001", "01101", 7.6e-18 * 0.01106 / 0.98420),
    ("01101", "02201", 1.05e-18 * 0.01106 / 0.98420),
]


def _hl_factor(J, l_lo, l_hi, dJ):
    """Hoenl-London factor for a linear-molecule branch (absorption,
    lower-state J; Herzberg conventions, unnormalized)."""
    if l_hi == l_lo + 1:
        if dJ == 1:
            return (J + l_lo + 1) * (J + l_lo + 2) / (2.0 * (J + 1))
        if dJ == 0:
            return (J - l_lo) * (J + l_lo + 1) * (2 * J + 1) \
                / (2.0 * J * (J + 1)) if J > 0 else 0.0
        return (J - l_lo) * (J - l_lo - 1) / (2.0 * J) if J > 0 else 0.0
    if l_hi == l_lo - 1:
        if dJ == 1:
            return (J - l_lo + 1) * (J - l_lo + 2) / (2.0 * (J + 1))
        if dJ == 0:
            return (J - l_lo + 1) * (J + l_lo) * (2 * J + 1) \
                / (2.0 * J * (J + 1)) if J > 0 else 0.0
        return (J + l_lo) * (J + l_lo - 1) / (2.0 * J) if J > 0 else 0.0
    # parallel Sigma-Sigma band (l = 0 -> 0): P/R only
    if dJ == 1:
        return float(J + 1)
    if dJ == -1:
        return float(J)
    return 0.0


def _j_exists(J, l, parity):
    if J < l:
        return False
    if parity == "g":
        return J % 2 == 0
    if parity == "u":
        return J % 2 == 1
    return True


def _co2_system(states, bands, j_max, nu_min, nu_max, mol_id, iso_row,
                rng):
    rows = []
    for lo_name, hi_name, s_band in bands:
        g_lo, b_lo, d_lo, l_lo, par_lo = states[lo_name]
        g_hi, b_hi, d_hi, l_hi, par_hi = states[hi_name]
        F = lambda B, D, J: B * J * (J + 1.0) - D * (J * (J + 1.0)) ** 2
        js, dks, nus, hls, els = [], [], [], [], []
        for J in range(max(l_lo, 1 if l_lo else 0), j_max):
            if not _j_exists(J, l_lo, par_lo):
                continue
            for dJ in (-1, 0, 1):
                Jp = J + dJ
                if Jp < 0 or not _j_exists(Jp, l_hi, par_hi):
                    continue
                hl = _hl_factor(J, l_lo, l_hi, dJ)
                if hl <= 0.0:
                    continue
                nu = (g_hi - g_lo) + F(b_hi, d_hi, Jp) - F(b_lo, d_lo, J)
                js.append(J)
                dks.append(dJ)
                nus.append(nu)
                hls.append(hl)
                els.append(g_lo + F(b_lo, d_lo, J))
        if not nus:
            continue
        nu = np.asarray(nus)
        el = np.asarray(els)
        hl = np.asarray(hls)
        J_arr = np.asarray(js, dtype=np.float64)
        # 296 K rotational population x stimulated-emission factor
        w = hl * np.exp(-C2_CM_K * el / T_REF) \
            * (1.0 - np.exp(-C2_CM_K * nu / T_REF))
        sw = s_band * w / w.sum()
        m = np.where(np.asarray(dks) == 1, J_arr + 1,
                     np.where(np.asarray(dks) == -1, -J_arr, J_arr))
        am = np.abs(m)
        # smooth J-dependent broadening/shift fits (HITRAN-magnitude)
        g_air = 0.0625 + 0.0325 * np.exp(-am / 22.0)
        g_self = 0.078 + 0.045 * np.exp(-am / 20.0)
        n_air = np.clip(0.78 - 0.0016 * am, 0.60, None)
        d_air = -(0.0015 + 3.0e-5 * am)
        sd = 0.10 + 0.02 * np.tanh((am - 20.0) / 20.0)
        keep = (nu >= nu_min) & (nu <= nu_max)
        rows.append(dict(nu0=nu[keep], sw=sw[keep], elower=el[keep],
                         gamma_air=g_air[keep], gamma_self=g_self[keep],
                         n_air=n_air[keep], delta_air=d_air[keep],
                         sd_air=sd[keep],
                         J=J_arr[keep].astype(np.int32),
                         dJ=np.asarray(dks, dtype=np.int32)[keep],
                         band=np.full(keep.sum(),
                                      f"{iso_row + 1}:{lo_name}->{hi_name}"),
                         # explicit per-row iso tag: a band can be skipped
                         # entirely (no surviving lines), so positional
                         # slicing of the rows list would miscount
                         iso_row=iso_row))
    return rows


def co2_lwir_lines(nu_min=500.0, nu_max=1200.0, j_max=100,
                   include_636=True):
    """CO2 LWIR line rows (dict of column arrays; see module docstring).

    Besides the LineStore columns, carries ``J``/``dJ``/``band``
    metadata used by the line-mixing derivation
    (:mod:`radtxfr_tpu.kernels.linemixing_data`)."""
    rng = np.random.default_rng(0)
    rows = _co2_system(_CO2_STATES_626, _CO2_BANDS_626, j_max, nu_min,
                       nu_max, 2, 0, rng)
    if include_636:
        rows += _co2_system(_CO2_STATES_636, _CO2_BANDS_636, j_max, nu_min,
                            nu_max, 2, 1, rng)
    out = {k: np.concatenate([r[k] for r in rows])
           for k in rows[0] if k != "iso_row"}
    # per-row iso tags (not positional slicing: _co2_system drops bands
    # that yield no in-range lines, so the rows list length is variable)
    iso = np.concatenate([
        np.full(r["nu0"].size, 2 if r["iso_row"] == 1 else 1,
                dtype=np.int32) for r in rows])
    n = out["nu0"].size
    out["mol_id"] = np.full(n, 2, dtype=np.int32)
    out["local_iso_id"] = iso       # HITRAN local iso id 2 = 636
    return out


#: N2O (linear, NON-symmetric: all J exist — no even/odd alternation,
#: comb spacing 2B ~ 0.84 cm^-1): name -> (Gv, Bv, Dv, l, parity=None).
_N2O_STATES = {
    "00001": (0.0,      0.4190110, 1.76e-7, 0, None),
    "01101": (588.768,  0.4199200, 1.78e-7, 1, None),
    "02001": (1168.132, 0.4196300, 1.80e-7, 0, None),
    "10001": (1284.903, 0.4172550, 1.75e-7, 0, None),
}
#: LWIR N2O bands (S at 296 K incl. 446-isotopologue abundance): the
#: nu1 band at 1284.9 sits inside the production band.
_N2O_BANDS = [
    ("00001", "10001", 9.8e-18),    # nu1, P/R comb inside 1240-1320
    ("00001", "02001", 2.4e-19),    # 2nu2 overtone at 1168.1
    ("00001", "01101", 2.45e-18),   # nu2 (Q at 588.8, band-edge)
]


def n2o_lwir_lines(nu_min=500.0, nu_max=1500.0, j_max=80):
    """N2O LWIR rows via the linear-molecule machinery (all-J combs)."""
    rng = np.random.default_rng(2)
    rows = _co2_system(_N2O_STATES, _N2O_BANDS, j_max, nu_min, nu_max,
                       4, 3, rng)
    shared = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
              "delta_air", "sd_air")
    out = {k: np.concatenate([r[k] for r in rows]) for k in shared}
    n = out["nu0"].size
    out["mol_id"] = np.full(n, 4, dtype=np.int32)
    out["local_iso_id"] = np.ones(n, dtype=np.int32)
    return out


def ch4_nu4_lines(nu_min=1150.0, nu_max=1420.0, j_max=20, seed=13):
    """CH4 nu4 (Q branch at ~1306.2 cm^-1) clump-statistics model.

    A spherical top's P/Q/R manifolds split tetrahedrally into clumps of
    fine-structure lines — the signature texture of the 7.7 um region.
    No effective Hamiltonian is attempted (documented approximation):
    clump centers follow nu0 + B'J'(J'+1) - B J(J+1) with B = 5.241,
    each clump carrying ~(2J+1) sub-lines spread by a J-growing width
    (~0.025 J^2 cm^-1) with deterministic pseudo-random offsets/weights;
    clump totals follow Hoenl-London x Boltzmann, band total ~5.2e-18.
    """
    rng = np.random.default_rng(seed)
    nu0_band, B, Bp = 1306.20, 5.2410, 5.2480
    s_band = 4.6e-18
    nus, els, wts = [], [], []
    for J in range(0, j_max):
        e_lo = B * J * (J + 1.0)
        for dJ in (-1, 0, 1):
            Jp = J + dJ
            if Jp < 0:
                continue
            hl = {1: J + 1.0, 0: (2 * J + 1.0) if J else 0.0, -1: float(J)}[dJ]
            if hl <= 0:
                continue
            center = nu0_band + Bp * Jp * (Jp + 1.0) - B * J * (J + 1.0)
            n_sub = 2 * J + 1
            spread = 0.045 * J * J + 0.08
            offs = rng.normal(0.0, spread, n_sub)
            w_sub = rng.dirichlet(np.full(n_sub, 1.5))
            boltz = (2 * J + 1.0) * np.exp(-C2_CM_K * e_lo / T_REF)
            nus.append(center + offs)
            els.append(np.full(n_sub, e_lo))
            wts.append(hl * boltz * w_sub / (2 * J + 1.0))
    nu = np.concatenate(nus)
    el = np.concatenate(els)
    w = np.concatenate(wts) * (1.0 - np.exp(-C2_CM_K * nu / T_REF))
    keep = (nu >= nu_min) & (nu <= nu_max)
    nu, el, w = nu[keep], el[keep], w[keep]
    sw = s_band * w / w.sum()
    n = nu.size
    return {
        "nu0": nu, "sw": sw, "elower": el,
        "gamma_air": np.full(n, 0.060) + rng.normal(0, 0.006, n).clip(-0.02, 0.02),
        "gamma_self": np.full(n, 0.078),
        "n_air": np.full(n, 0.73),
        "delta_air": np.full(n, -0.002),
        "sd_air": np.zeros(n),
        "mol_id": np.full(n, 6, dtype=np.int32),
        "local_iso_id": np.ones(n, dtype=np.int32),
    }


# ---------------------------------------------------------------------------
# O3: near-prolate symmetric-top approximation of the 9.6 um system
# ---------------------------------------------------------------------------

#: O3 rotational constants [cm^-1] (ground: A=3.5537, B=0.4453, C=0.3948;
#: kappa ~ -0.97 -> prolate approximation with Bbar=(B+C)/2).
_O3_GROUND = (3.5537, 0.44526, 0.39479)
#: (band center, upper-state (A', Bbar' scale), total S at 296 K) — nu3 is
#: the strong 9.6 um band (~1.4e-17), nu1 the weak companion, nu2 the
#: 14 um band whose R branch crosses the 690-750 cm^-1 production region.
_O3_BANDS = [
    (1042.084, 0.9965, 1.40e-17),   # nu3
    (1103.137, 0.9976, 4.50e-19),   # nu1
    (700.931, 1.0110, 4.00e-18),    # nu2 (A' grows ~1% for the bend)
]


def o3_lwir_lines(nu_min=550.0, nu_max=1200.0, j_max=90, k_max=40):
    """O3 nu2/nu3/nu1 band rows (near-prolate symmetric-top
    approximation)."""
    A, B, C = _O3_GROUND
    bbar = 0.5 * (B + C)
    asym = 0.25 * (B - C)           # K=1 asymmetry-splitting scale

    def e_rot(J, K, A_c, b_c, comp):
        e = b_c * J * (J + 1.0) + (A_c - b_c) * K * K
        if K == 1:
            e = e + comp * asym * J * (J + 1.0)
        return e

    rows = {k: [] for k in ("nu0", "sw", "elower", "gamma_air",
                            "gamma_self", "n_air", "delta_air", "sd_air")}
    for nu0_band, up_scale, s_band in _O3_BANDS:
        Ap, bp = A * up_scale, bbar * up_scale
        nus, els, wts, ms = [], [], [], []
        for K in range(0, k_max + 1):
            comps = (1.0, -1.0) if K == 1 else ((0.0,) if K == 0 else
                                                (1.0, -1.0))
            for comp in comps:
                for J in range(max(K, 1), j_max):
                    if (J + K) % 2:      # spin-0 O: half the levels absent
                        continue
                    e_lo = e_rot(J, K, A, bbar, comp)
                    for dJ in (-1, 0, 1):
                        Jp = J + dJ
                        if Jp < K:
                            continue
                        # a-type symmetric-top HL factors
                        if dJ == 1:
                            hl = ((J + 1.0) ** 2 - K * K) / (J + 1.0)
                        elif dJ == 0:
                            hl = K * K * (2.0 * J + 1) / (J * (J + 1.0))
                        else:
                            hl = (J * J - K * K) / float(J)
                        if hl <= 0:
                            continue
                        nu = nu0_band + e_rot(Jp, K, Ap, bp, comp) - e_lo
                        nus.append(nu)
                        els.append(e_lo)
                        wts.append(hl * (2 - (K == 0))
                                   * np.exp(-C2_CM_K * e_lo / T_REF))
                        ms.append(Jp if dJ == 1 else (-J if dJ == -1 else J))
        nu = np.asarray(nus)
        el = np.asarray(els)
        w = np.asarray(wts) * (1.0 - np.exp(-C2_CM_K * nu / T_REF))
        sw = s_band * w / w.sum()
        am = np.abs(np.asarray(ms, dtype=np.float64))
        keep = (nu >= nu_min) & (nu <= nu_max)
        rows["nu0"].append(nu[keep])
        rows["sw"].append(sw[keep])
        rows["elower"].append(el[keep])
        rows["gamma_air"].append((0.0640 + 0.012 * np.exp(-am / 25.0))[keep])
        rows["gamma_self"].append((0.082 + 0.016 * np.exp(-am / 25.0))[keep])
        rows["n_air"].append(np.full(keep.sum(), 0.76))
        rows["delta_air"].append(np.full(keep.sum(), -0.0011))
        rows["sd_air"].append(np.full(keep.sum(), 0.08))
    out = {k: np.concatenate(v) for k, v in rows.items()}
    n = out["nu0"].size
    out["mol_id"] = np.full(n, 3, dtype=np.int32)
    out["local_iso_id"] = np.ones(n, dtype=np.int32)
    return out


# ---------------------------------------------------------------------------
# H2O: rigid asymmetric rotor by direct diagonalization
# ---------------------------------------------------------------------------

#: Watson constants [cm^-1]: (A, B, C, DJ, DJK, DK) — ground and nu2.
_H2O_GROUND = (27.8806, 14.5216, 9.2778, 1.25e-3, -5.7e-3, 2.60e-2)
_H2O_NU2 = (31.070, 14.670, 9.140, 1.50e-3, -7.0e-3, 4.00e-2)
_H2O_NU2_G = 1594.746


def _asym_levels(J, const):
    """Eigen-decomposition of the Watson A-reduced rotor at J.

    Returns (E sorted ascending, eigvec columns in the signed-k prolate
    basis k = -J..J, (Ka, Kc) assignments by energy ordering)."""
    A, B, C, dj, djk, dk = const
    k = np.arange(-J, J + 1)
    jj = J * (J + 1.0)
    diag = 0.5 * (B + C) * (jj - k * k) + A * k * k \
        - dj * jj * jj - djk * jj * k * k - dk * k ** 4
    f = lambda kk: np.sqrt(jj - kk * (kk + 1.0))
    H = np.diag(diag)
    if k.size > 2:
        off = 0.25 * (B - C) * f(k[:-2] + 1) * f(k[:-2])   # <k+2|H|k>
        H = H + np.diag(off, 2) + np.diag(off, -2)
    E, V = np.linalg.eigh(H)
    idx = np.arange(2 * J + 1)
    ka = (idx + 1) // 2
    kc = J - idx // 2
    return E, V, ka, kc


def _dircos_b(J, Jp):
    """Signed direction-cosine amplitude matrix for a b-type (Delta k =
    +-1) transition J -> Jp in the signed-k basis (standard ladder
    elements; common J-dependent factors drop out after normalization)."""
    k = np.arange(-J, J + 1)
    M = np.zeros((2 * Jp + 1, 2 * J + 1))
    kp = np.arange(-Jp, Jp + 1)
    for i, kk in enumerate(k):
        for s in (+1, -1):
            kt = kk + s
            j = np.searchsorted(kp, kt)
            if j < 0 or j >= kp.size or kp[j] != kt:
                continue
            if Jp == J + 1:
                amp = np.sqrt((J + s * kk + 1.0) * (J + s * kk + 2.0))
            elif Jp == J:
                amp = s * np.sqrt((J - s * kk) * (J + s * kk + 1.0))
            else:
                amp = -np.sqrt((J - s * kk) * (J - s * kk - 1.0))
            M[j, i] += 0.5 * amp
    return M


def _h2o_band(const_lo, const_hi, g_vib, s_band, j_max, nu_min, nu_max):
    levels = {J: _asym_levels(J, const_lo) for J in range(j_max + 1)}
    upper = ({J: _asym_levels(J, const_hi) for J in range(j_max + 1)}
             if const_hi is not const_lo else levels)
    nus, els, wts = [], [], []
    for J in range(j_max + 1):
        E, V, ka, kc = levels[J]
        for dJ in (-1, 0, 1):
            Jp = J + dJ
            if Jp < 0 or Jp > j_max:
                continue
            if g_vib == 0.0 and dJ < 0:
                continue            # pure rotation: emission duplicate
            Ep, Vp, kap, kcp = upper[Jp]
            M = _dircos_b(J, Jp)
            amp = Vp.T @ M @ V      # (2Jp+1, 2J+1) eigenbasis amplitudes
            str2 = amp * amp
            g_ns = np.where((ka + kc) % 2, 3.0, 1.0)       # (2J+1,)
            nu_g = g_vib + Ep[:, None] - E[None, :]        # (2Jp+1, 2J+1)
            sel = (str2 >= 1e-8) & (nu_g >= nu_min) & (nu_g <= nu_max)
            hi_i, lo_i = np.nonzero(sel)
            nus.extend(nu_g[hi_i, lo_i].tolist())
            els.extend(E[lo_i].tolist())
            wts.extend((str2[hi_i, lo_i] * g_ns[lo_i]
                        * np.exp(-C2_CM_K * E[lo_i] / T_REF)).tolist())
    nu = np.asarray(nus)
    el = np.asarray(els)
    w = np.asarray(wts) * (1.0 - np.exp(-C2_CM_K * np.abs(nu) / T_REF))
    sw = s_band * w / w.sum()
    return nu, sw, el


def h2o_lwir_lines(nu_min=500.0, nu_max=1500.0, j_max=30):
    """H2O rows: rotational-band lines (strong, irregular) + the nu2
    P-branch edge above ~1300 cm^-1.

    The rigid-rotor model places too much high-J strength in the
    650-850 cm^-1 shoulder (real H2O's centrifugal distortion empties
    that region faster than rigid energies suggest); an empirical
    envelope 1 - 0.9 exp(-((nu-720)/110)^2) suppresses it so band-level
    ground-to-space optical depths land at the observed magnitudes
    (~2-5 at 741, ~0.05 in the 1000 cm^-1 window) — a documented
    calibration of the structural fixture, not a fit to HITRAN."""
    nu_r, sw_r, el_r = _h2o_band(_H2O_GROUND, _H2O_GROUND, 0.0, 3.5e-18,
                                 j_max, nu_min, nu_max)
    sw_r = sw_r * (1.0 - 0.90 * np.exp(-(((nu_r - 720.0) / 110.0) ** 2)))
    nu_2, sw_2, el_2 = _h2o_band(_H2O_GROUND, _H2O_NU2, _H2O_NU2_G,
                                 1.0e-17, j_max, nu_min, nu_max)
    nu = np.concatenate([nu_r, nu_2])
    sw = np.concatenate([sw_r, sw_2])
    el = np.concatenate([el_r, el_2])
    n = nu.size
    rng = np.random.default_rng(7)
    # J/Ka-dependent widths vary strongly for H2O; emulate the HITRAN
    # spread (0.01-0.11 air) correlated with E" (high-E" lines narrower)
    g_air = np.clip(0.102 - 1.6e-5 * el + rng.normal(0, 0.008, n),
                    0.012, 0.11)
    return {
        "nu0": nu, "sw": sw, "elower": el,
        "gamma_air": g_air,
        "gamma_self": np.clip(g_air * (4.7 + rng.normal(0, 0.3, n)),
                              0.05, 0.55),
        "n_air": np.clip(0.68 + rng.normal(0, 0.08, n), 0.35, 0.96),
        "delta_air": rng.normal(-0.004, 0.004, n),
        "sd_air": np.clip(rng.normal(0.11, 0.03, n), 0.0, 0.2),
        "mol_id": np.full(n, 1, dtype=np.int32),
        "local_iso_id": np.ones(n, dtype=np.int32),
    }


# ---------------------------------------------------------------------------
# Combined fixture
# ---------------------------------------------------------------------------

def derived_lwir_columns(nu_min=500.0, nu_max=1500.0, min_sw=1e-27):
    """The H2O+CO2+O3+N2O+CH4 LWIR list as NumPy columns (``nu0``, ``sw``,
    ``elower``, ``gamma_air``, ``gamma_self``, ``n_air``, ``delta_air``,
    ``sd_air``, ``mol_id``, ``local_iso_id``), unsorted."""
    return _derived_columns(float(nu_min), float(nu_max), float(min_sw))


@functools.lru_cache(maxsize=4)
def _derived_columns(nu_min, nu_max, min_sw):
    parts = [h2o_lwir_lines(nu_min, nu_max),
             co2_lwir_lines(max(nu_min, 500.0), min(nu_max, 1200.0)),
             o3_lwir_lines(max(nu_min, 550.0), min(nu_max, 1200.0)),
             n2o_lwir_lines(nu_min, nu_max),
             ch4_nu4_lines(max(nu_min, 1150.0), min(nu_max, 1420.0))]
    shared = set(parts[0]) & set(parts[1]) & set(parts[2])
    cols = {k: np.concatenate([p[k] for p in parts]) for k in shared}
    keep = cols["sw"] >= min_sw
    return {k: v[keep] for k, v in cols.items()}
