"""Plain reference of the 'mt_ckd' continuum composite (LBLRTM's ICNTNM=6
production setup as the reference package formulates it): the table-driven
H2O self and foreign continuum (two-table exponential temperature law),
the chi-corrected CO2 far-wing continuum, N2 and O2 collision-induced
absorption and Rayleigh extinction, all scale factors 1.

The coefficient tables are the configuration's published constants,
frozen here: the H2O anchors (literature-anchored to Burch & Alt 1984,
Mlawer et al. 2012, Ptashnik et al. 2011; ``radtxfr_tpu_torch/atmos/
continuum.py:87-135``), the CO2 far-wing table built from the frozen
derived CO2 band system (:mod:`..inputs.derived_lines`; the construction
of ``atmos/far_wing.py:27-85``) and the CIA band models
(``far_wing.py:102-139``). Each OD is evaluated in float64 NumPy at the
points asked for.
"""

from __future__ import annotations

import functools
import math

import numpy as np

from .lbl import (BARYE_PER_ATM, C2_CM_K, CM_PER_KM, K_B_CGS, PA_PER_ATM,
                  T_REF, IsoData)

_NU = np.array([
    400.0, 450.0, 500.0, 550.0, 600.0, 650.0, 700.0, 750.0, 800.0,
    850.0, 900.0, 944.0, 1000.0, 1060.0, 1100.0, 1150.0, 1200.0,
    1250.0, 1300.0, 1350.0, 1400.0, 1450.0, 1500.0, 1600.0,
    1700.0, 1800.0, 1900.0, 2000.0, 2100.0, 2200.0, 2300.0, 2400.0,
    2500.0, 2600.0, 2800.0, 3000.0, 3200.0, 3400.0, 3600.0, 3750.0,
    3900.0, 4100.0, 4400.0, 4700.0, 5000.0, 5150.0, 5300.0, 5600.0,
    6000.0, 6300.0, 6600.0, 7000.0, 7100.0])
_CS296 = np.array([
    4.0e-20, 2.0e-20, 8.5e-21, 4.4e-21, 2.4e-21, 1.4e-21, 8.0e-22,
    5.9e-22, 4.4e-22, 3.3e-22, 2.5e-22, 2.0e-22, 1.55e-22, 1.25e-22,
    1.05e-22, 9.0e-23, 8.0e-23, 8.2e-23, 1.0e-22, 1.6e-22, 2.8e-22,
    5.0e-22, 9.0e-22, 2.6e-21,
    3.0e-21, 1.3e-21, 3.0e-22, 6.0e-23, 2.0e-23, 1.3e-23, 1.0e-23,
    8.0e-24, 4.5e-24, 3.5e-24, 1.0e-23, 5.0e-23, 2.0e-22, 8.0e-22,
    2.0e-21, 3.0e-21, 1.5e-21, 2.0e-22, 8.0e-24, 8.0e-25, 2.0e-24,
    2.0e-23, 8.0e-23, 2.0e-23, 2.5e-25, 4.0e-25, 1.0e-24, 1.0e-23,
    2.0e-23])
_T0 = np.array([
    800.0, 900.0, 1000.0, 1150.0, 1300.0, 1500.0, 1700.0, 1800.0, 1800.0,
    1800.0, 1800.0, 1800.0, 1800.0, 1800.0, 1800.0, 1750.0, 1700.0,
    1600.0, 1450.0, 1250.0, 1050.0, 900.0, 850.0, 800.0,
    800.0, 900.0, 1100.0, 1400.0, 1600.0, 1800.0, 1900.0, 2000.0,
    2000.0, 2000.0, 1700.0, 1400.0, 1100.0, 900.0, 800.0, 800.0,
    900.0, 1200.0, 1600.0, 1800.0, 1500.0, 1100.0, 900.0, 1200.0,
    1700.0, 1600.0, 1400.0, 1000.0, 900.0])
_CF = np.array([
    6.0e-23, 3.0e-23, 1.5e-23, 7.0e-24, 3.5e-24, 1.8e-24, 9.0e-25,
    5.0e-25, 3.0e-25, 2.0e-25, 1.4e-25, 1.1e-25, 1.0e-25, 1.1e-25,
    1.3e-25, 1.8e-25, 2.8e-25, 5.0e-25, 1.2e-24, 3.5e-24, 1.0e-23,
    2.5e-23, 5.0e-23, 1.5e-22,
    1.2e-22, 3.0e-23, 5.0e-24, 8.0e-25, 1.5e-25, 5.0e-26, 3.0e-26,
    2.5e-26, 2.0e-26, 2.5e-26, 1.0e-25, 6.0e-25, 3.0e-24, 1.0e-23,
    2.5e-23, 3.0e-23, 1.0e-23, 8.0e-25, 4.0e-26, 1.5e-26, 5.0e-26,
    8.0e-25, 3.0e-24, 3.0e-25, 1.0e-26, 2.0e-26, 8.0e-26, 8.0e-25,
    1.5e-24])
_CS260 = _CS296 * np.exp(_T0 * (1.0 / 260.0 - 1.0 / 296.0))

_CO2_T = (200.0, 220.0, 240.0, 260.0, 280.0, 296.0, 320.0)


def _chi(dnu, T):
    """Sub-Lorentzian chi factor of CO2-air far wings."""
    dnu = np.abs(dnu)
    ts = math.sqrt(296.0 / T)
    b1, b2, b3 = 0.0888 * ts, 0.04 * ts, 0.0232 * ts
    chi30 = math.exp(-b1 * 27.0)
    chi120 = chi30 * math.exp(-b2 * 90.0)
    return np.where(dnu <= 3.0, 1.0,
                    np.where(dnu <= 30.0, np.exp(-b1 * (dnu - 3.0)),
                             np.where(dnu <= 120.0,
                                      chi30 * np.exp(-b2 * (dnu - 30.0)),
                                      chi120 * np.exp(-b3 * (dnu - 120.0)))))


@functools.lru_cache(maxsize=1)
def co2_table():
    """(nu, T, C): C(nu, T) = sum_k S_k(T) chi gamma_k(T, 1 atm) /
    (pi dnu^2) over the |dnu| > 25 cm^-1 wings of the derived CO2 system,
    on 400-1500 cm^-1 by 2 and the rows' temperatures [cm^2/molec/atm]."""
    from ..inputs.derived_lines import co2_lwir_lines

    rows = co2_lwir_lines(nu_min=400.0, nu_max=1900.0)
    iso = IsoData.load()
    q626 = iso.q[iso.row_of[(2, 1)]]
    t_dat = 60.0 + 25.0 * np.arange(q626.size)
    nu = np.arange(400.0, 1500.0 + 2.0, 2.0)
    C = np.zeros((len(_CO2_T), nu.size))
    n0, el = rows["nu0"], rows["elower"]
    for r, T in enumerate(_CO2_T):
        q_t, q_ref = np.interp(T, t_dat, q626), np.interp(T_REF, t_dat, q626)
        s = rows["sw"] * (q_ref / q_t) * (
            np.exp(-C2_CM_K * el / T) * (1.0 - np.exp(-C2_CM_K * n0 / T))
            / (np.exp(-C2_CM_K * el / T_REF)
               * (1.0 - np.exp(-C2_CM_K * n0 / T_REF))))
        g = rows["gamma_air"] * (T_REF / T) ** rows["n_air"]
        dn = nu[:, None] - n0[None, :]
        far = np.abs(dn) > 25.0
        with np.errstate(divide="ignore"):
            wing = g[None, :] / (np.pi * dn * dn)
        C[r] = np.where(far, _chi(dn, T) * wing, 0.0) @ s
    return nu, np.asarray(_CO2_T), C


def mt_ckd_od(nu: np.ndarray, T, p_pa, pl_km, vmr: np.ndarray, mol_ids):
    """(nLay, P) continuum OD at the points ``nu`` of layers with T [K],
    p [Pa], path [km] (nLay,) and vmr (nLay, nM) in the columns
    ``mol_ids``."""
    T = np.asarray(T, np.float64)[:, None]
    p_pa = np.asarray(p_pa, np.float64)[:, None]
    pl = np.asarray(pl_km, np.float64)[:, None] * CM_PER_KM
    p_atm = p_pa / PA_PER_ATM
    col = {m: i for i, m in enumerate(mol_ids)}
    x = lambda m: vmr[:, col[m], None]  # noqa: E731
    n_tot = p_atm * BARYE_PER_ATM / (K_B_CGS * T)
    out = np.zeros((T.shape[0], nu.size))
    if 1 in col:
        l296 = np.interp(nu, _NU, np.log(_CS296))
        dl = np.interp(nu, _NU, np.log(_CS260)) - l296
        cs = np.exp(l296[None, :] + (296.0 - T) / 36.0 * dl[None, :])
        cfor = np.exp(np.interp(nu, _NU, np.log(_CF)))[None, :]
        e = x(1) * p_atm
        out += (cs * e + cfor * (p_atm - e)) * x(1) * n_tot * pl
    if 2 in col:
        tn, tt, C = co2_table()
        rows = np.stack([np.interp(nu, tn, r) for r in C])   # (nT, P)
        i = np.clip(np.searchsorted(tt, T[:, 0]) - 1, 0, tt.size - 2)
        w = np.clip((T[:, 0] - tt[i]) / (tt[i + 1] - tt[i]), 0.0, 1.0)
        c = (1.0 - w)[:, None] * rows[i] + w[:, None] * rows[i + 1]
        out += c * x(2) * n_tot * p_atm * pl
    # CIA (N2 rototranslational, O2 fundamental) [cm^-1 amagat^-2]
    nu_p = 55.0 * np.sqrt(T / 296.0)
    xr = np.abs(nu)[None, :] / nu_p
    c_n2 = (1.1e-6 * (296.0 / T) ** 1.5) * xr * xr * np.exp(-xr) \
        * (math.e ** 2 / 4.0)
    d = nu[None, :] - 1556.0
    red = np.where(d < 0, np.exp(C2_CM_K * d / (2.0 * T)), 1.0)
    c_o2 = 2.0e-7 * (296.0 / T) * np.exp(-0.5 * (d / 110.0) ** 2) * red
    x_n2 = x(22) if 22 in col else 0.7808
    x_o2 = x(7) if 7 in col else 0.2095
    rho = p_atm * (273.15 / T)
    out += (c_n2 * x_n2 + c_o2 * x_o2) * rho * rho * pl
    # Rayleigh
    n_ref = 1.0 + 2.79e-4
    lor = (n_ref ** 2 - 1.0) / (n_ref ** 2 + 2.0)
    sigma = 24.0 * math.pi ** 3 * (nu * nu / 2.546899e19) ** 2 * lor ** 2 \
        * 1.061
    out += sigma[None, :] * (p_pa * 10.0) / (K_B_CGS * T) * pl
    return out
