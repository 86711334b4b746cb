"""CO2 nu2 far-wing (chi-factor) continuum table (counterpart of
``radtxfr_tpu/atmos/far_wing.py``; the same NumPy construction).

C(nu, T) = sum_k S_k(T) chi(|nu - nu_k|, T) gamma_k(T, 1 atm)
/ (pi (nu - nu_k)^2) over the |nu - nu_k| > 25 cm^-1 wings of the derived
CO2 band system, in cm^2 molec^-1 atm^-1; and the N2/O2 collision-induced
band models that both MT_CKD evaluators of :mod:`.continuum` call.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import as_numpy
from ..core.constants import C2_CM_K, T_REF

__all__ = ["chi_factor_co2", "co2_continuum_table",
           "cia_n2_rototranslational", "cia_o2_gaussian", "cia_o2_band",
           "cia_o2_fundamental"]

_CUTOFF = 25.0     # cm^-1, the LBLRTM line/continuum split


def chi_factor_co2(dnu, T=T_REF):
    """Sub-Lorentzian chi factor for CO2-air far wings (see module doc)."""
    dnu = np.abs(np.asarray(dnu, dtype=np.float64))
    ts = np.sqrt(296.0 / T)
    b1, b2, b3 = 0.0888 * ts, 0.04 * ts, 0.0232 * ts
    chi30 = np.exp(-b1 * 27.0)
    chi120 = chi30 * np.exp(-b2 * 90.0)
    return np.where(
        dnu <= 3.0, 1.0,
        np.where(dnu <= 30.0, np.exp(-b1 * (dnu - 3.0)),
                 np.where(dnu <= 120.0, chi30 * np.exp(-b2 * (dnu - 30.0)),
                          chi120 * np.exp(-b3 * (dnu - 120.0)))))


def _co2_strength_t(rows, T, iso_q):
    """S_k(T) from the 296 K intensities (TIPS ratio + Boltzmann)."""
    q_t = np.interp(T, iso_q["Tdat"], iso_q["q626"])
    q_ref = np.interp(T_REF, iso_q["Tdat"], iso_q["q626"])
    nu, el = rows["nu0"], rows["elower"]
    ch = np.exp(-C2_CM_K * el / T) * (1.0 - np.exp(-C2_CM_K * nu / T))
    zn = np.exp(-C2_CM_K * el / T_REF) * (1.0 - np.exp(-C2_CM_K * nu / T_REF))
    return rows["sw"] * (q_ref / q_t) * (ch / zn)


@functools.lru_cache(maxsize=2)
def co2_continuum_table(nu_min=400.0, nu_max=1500.0, dnu_grid=2.0,
                        t_grid=(200.0, 220.0, 240.0, 260.0, 280.0,
                                296.0, 320.0)):
    """(nu, T, C) table of the chi-corrected CO2 far-wing continuum.

    ``C`` has shape (len(t_grid), n_nu) in cm^2 molec^-1 atm^-1. Smooth
    by construction (only |dnu| > 25 cm^-1 wings contribute), so a
    2 cm^-1 grid is ample.
    """
    from ..lines.derived import co2_lwir_lines
    from ..lines.tips import load_tips_tables

    rows = co2_lwir_lines(nu_min=max(400.0, nu_min - 400.0),
                          nu_max=nu_max + 400.0)
    mol, iso, _gsi, q = load_tips_tables()
    r626 = int(np.nonzero((np.asarray(mol) == 2)
                          & (np.asarray(iso) == 1))[0][0])
    t_dat = 60.0 + 25.0 * np.arange(np.asarray(q).shape[1])
    iso_q = {"Tdat": t_dat, "q626": np.asarray(q)[r626]}

    nu = np.arange(nu_min, nu_max + dnu_grid, dnu_grid)
    C = np.zeros((len(t_grid), nu.size))
    for r, T in enumerate(t_grid):
        s_t = _co2_strength_t(rows, T, iso_q)
        g_t = rows["gamma_air"] * (T_REF / T) ** rows["n_air"]   # 1 atm
        dn = nu[:, None] - rows["nu0"][None, :]
        far = np.abs(dn) > _CUTOFF
        with np.errstate(divide="ignore"):
            wing = g_t[None, :] / (np.pi * dn * dn)
        chi = chi_factor_co2(dn, T)
        C[r] = np.where(far, chi * wing, 0.0) @ s_t
    return nu, np.asarray(t_grid, dtype=np.float64), C


def _xp_inputs(nu, T, xp):
    """``nu`` and ``T`` for ``xp``: a host NumPy ``nu`` (a tensor copied
    off its device) and ``T`` as given, or a tensor ``nu`` and a tensor
    ``T`` (a number on ``nu``'s device in its dtype)."""
    if xp is np:
        return as_numpy(nu), T
    nu = torch.as_tensor(nu)
    if not isinstance(T, torch.Tensor):
        T = torch.as_tensor(T, dtype=nu.dtype, device=nu.device)
    return nu, T


def cia_n2_rototranslational(nu, T=T_REF, xp=np):
    """N2-N2 (+N2-O2, folded) rototranslational CIA coefficient
    [cm^-1 amagat^-2]: a (nu/nu_p)^2 exp(-nu/nu_p) with the peak near
    2 nu_p ~ 110 cm^-1 scaling ~T^-1.5 (Borysow & Frommhold 1986 class).
    ``xp=np`` takes and returns NumPy, as JAX's; ``xp=torch`` tensors
    (``nu`` and ``T`` broadcast)."""
    nu, T = _xp_inputs(nu, T, xp)
    nu = xp.abs(nu)
    nu_p = 55.0 * xp.sqrt(T / 296.0)
    amp = 1.1e-6 * (296.0 / T) ** 1.5
    x = nu / nu_p
    # normalised so the maximum of x^2 e^-x (at x = 2) equals amp
    return amp * x * x * xp.exp(-x) * (np.e ** 2 / 4.0)


def cia_o2_gaussian(nu, xp=np):
    """The O2 band's part that depends on nu alone: the offset d = nu - 1556
    cm^-1 from its centre and its Gaussian exp(-(d / 110)^2 / 2); ``xp``
    NumPy (the layered evaluator's host precompute) or torch."""
    d = nu - 1556.0
    return d, xp.exp(-0.5 * (d / 110.0) ** 2)


def cia_o2_band(d, gaussian, T):
    """The O2 CIA coefficient from :func:`cia_o2_gaussian`'s ``d`` and
    ``gaussian`` (NumPy or tensors): amplitude 2e-7 (296/T) with the
    detailed-balance wing ratio exp(-c2 |d| / 2T) on the red side."""
    if isinstance(d, torch.Tensor):
        red = torch.where(d < 0, torch.exp(C2_CM_K * d / (2.0 * T)),
                          torch.ones((), dtype=d.dtype, device=d.device))
    else:
        red = np.where(d < 0, np.exp(C2_CM_K * d / (2.0 * T)), 1.0)
    return 2.0e-7 * (296.0 / T) * gaussian * red


def cia_o2_fundamental(nu, T=T_REF, xp=np):
    """O2 fundamental-band CIA coefficient [cm^-1 amagat^-2]: a Gaussian at
    1556 cm^-1 with the detailed-balance wing ratio exp(-c2 dnu / T) on the
    red side (Thibault et al. 1997 class). ``xp=np`` takes and returns
    NumPy, as JAX's; ``xp=torch`` tensors (``nu`` and ``T`` broadcast)."""
    nu, T = _xp_inputs(nu, T, xp)
    return cia_o2_band(*cia_o2_gaussian(nu, xp), T)
