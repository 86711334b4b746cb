"""Hartmann-Tran column resolution and per-line parameters (counterpart of
``radtxfr_tpu/kernels/ht_driver.py``: ``resolve_ht_columns``,
``ht_params``).

hapi's ``absorptionCoefficient_HT`` (``misc/hapi.py:10302-10650``) resolves,
per diluent, the HT columns with fallbacks to the Voigt-era ones:

* Gamma0:  ``gamma_HT_0_<d>_296`` (nonzero) -> ``gamma_<d>`` -> 0; exponent
  ``n_HT_<d>_296`` (nonzero) -> ``n_<d>`` (self falls back to ``n_air``
  where zero) -> ``n_air``; scaled by (p/pref)(Tref/T)^n.
* Shift0:  ``delta_HT_0_<d>_296`` -> ``delta_<d>`` -> 0, plus the linear T
  term ``deltap_HT_<d>_296`` -> ``deltap_<d>`` -> 0.
* Gamma2:  ``gamma_HT_2_<d>_296`` -> ``SD_<d>`` * Gamma0DB -> 0; times p/pref.
* Shift2:  ``delta_HT_2_<d>_296`` -> 0; times p/pref.
* nuVC:    ``nu_HT_<d>`` (Tref/T)^``kappa_HT_<d>`` p.
* eta:     Sum_d eta_d abun_d (Gamma0T_d + i Shift0T_d) / (Gamma0 + i Shift0).

The selection runs on the host in NumPy over the concrete columns
(:func:`resolve_ht_columns`); :func:`ht_params` scales them to (T, p) in
torch, so tangents flow through it. eta is carried as the real pair
(``eta_r``, ``eta_i``): its value is the JAX driver's complex eta, and
``torch.func.jvp``/``vmap`` meet only real operations; with
``complex_dtype`` the dict also holds the complex ``eta``.

:func:`xsect_ht` and :func:`ht_xsect_from_params` are the reference (jnp)
engine's HT line sum: the complex pcqsdhc of :mod:`.htp` over chunks of
(lines x grid), with hapi's window mask.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import arrays_on, as_numpy
from ..core.constants import P_REF, T_REF
from .htp import pcqsdhc
from .lineparams import compute_line_params
from .xsect import live_chunks

__all__ = ["xsect_ht", "resolve_ht_columns", "ht_params",
           "ht_xsect_from_params"]


def _col(lines, extras, name, default=0.0):
    """A per-line column from ``extras`` or the store's host columns."""
    attr = {"gamma_air": "gamma_air", "gamma_self": "gamma_self",
            "n_air": "n_air", "delta_air": "delta_air",
            "SD_air": "sd_air"}.get(name)
    if extras and name in extras:
        return as_numpy(extras[name], np.float64)
    if attr is not None and attr in lines.host:
        return np.asarray(lines.host[attr], dtype=np.float64)
    return np.full(lines.host["nu0"].shape[0], default)


def _nz(primary, fallback):
    """hapi's 'primary where nonzero, else fallback'."""
    return np.where(primary != 0.0, primary, fallback)


def resolve_ht_columns(lines, extras, diluent) -> list:
    """Host-side column resolution per diluent (hapi's fallbacks, see the
    module docstring): a list of (abundance, g0db, ndb, d0, dp, g2db, d2db,
    nuvc_db, kappa_db, eta_db), the arrays float64 NumPy (L,)."""
    resolved = []
    for d, abun in diluent.items():
        d = d.lower()
        g0db = _nz(_col(lines, extras, f"gamma_HT_0_{d}_296"),
                   _col(lines, extras, f"gamma_{d}"))
        n_ht = _col(lines, extras, f"n_HT_{d}_296")
        n_plain = _col(lines, extras, f"n_{d}")
        if d == "self":
            n_plain = _nz(n_plain, _col(lines, extras, "n_air"))
        has_n_plain = (extras and f"n_{d}" in extras) or d in ("air", "self")
        ndb = _nz(n_ht, n_plain if has_n_plain
                  else _col(lines, extras, "n_air"))
        d0 = _nz(_col(lines, extras, f"delta_HT_0_{d}_296"),
                 _col(lines, extras, f"delta_{d}"))
        dp = _nz(_col(lines, extras, f"deltap_HT_{d}_296"),
                 _col(lines, extras, f"deltap_{d}"))
        g2db = _nz(_col(lines, extras, f"gamma_HT_2_{d}_296"),
                   _col(lines, extras, f"SD_{d}") * g0db)
        resolved.append((float(abun), g0db, ndb, d0, dp, g2db,
                         _col(lines, extras, f"delta_HT_2_{d}_296"),
                         _col(lines, extras, f"nu_HT_{d}"),
                         _col(lines, extras, f"kappa_HT_{d}"),
                         _col(lines, extras, f"eta_HT_{d}")))
    return resolved


def ht_params(resolved, lines, iso, T, p_atm, wing_abs=0.0, wing_hw=50.0,
              complex_dtype=None, abun=None, strength_scale=1.0) -> dict:
    """Per-line HT parameters at (T [K], p [atm]) from resolved columns
    (``ht_driver.py:98-155``): strength, gamma_d, gamma0, shift0, gamma2,
    shift2, nuvc, eta_r, eta_i and wing, in the store's dtype on its device.

    ``T`` and ``p_atm`` broadcast against the (L,) columns: (nLay, 1) give
    (nLay, L). ``abun`` overrides the resolved abundances (one scalar or
    tensor per diluent: the layered OD passes [1 - x_self, x_self]);
    ``strength_scale`` multiplies the strengths (the species column
    density, for OD units); ``complex_dtype`` (e.g. ``torch.complex128``)
    adds the complex ``eta`` = eta_r + i eta_i in that dtype, the JAX
    driver's eta. NumPy ``T``, ``p_atm``, ``abun`` and
    ``strength_scale`` join the store's device in its dtype.
    """
    dev, dt = lines.sw.device, lines.sw.dtype
    T = torch.as_tensor(T, dtype=dt, device=dev)
    p = torch.as_tensor(p_atm, dtype=dt, device=dev)
    # NumPy abundances and scales join the store's device in its dtype
    if abun is not None:
        abun = list(arrays_on(*abun, device=dev, dtype=dt))
    strength_scale, = arrays_on(strength_scale, device=dev, dtype=dt)
    lp = compute_line_params(lines, iso, T, p, strength_scale=strength_scale)
    t = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    gamma0 = shift0 = gamma2 = shift2 = nuvc = eta_nr = eta_ni = 0.0
    for i, (a_res, g0db, ndb, d0, dp, g2db, d2db, nuvc_db, kappa_db,
            eta_db) in enumerate(resolved):
        a = a_res if abun is None else abun[i]
        g0t = t(g0db) * (p / P_REF) * (T_REF / T) ** t(ndb)
        s0t = (t(d0) + t(dp) * (T - T_REF)) * (p / P_REF)
        gamma0 = gamma0 + a * g0t
        shift0 = shift0 + a * s0t
        gamma2 = gamma2 + a * t(g2db) * (p / P_REF)
        shift2 = shift2 + a * t(d2db) * (p / P_REF)
        nuvc = nuvc + a * t(nuvc_db) * (T_REF / T) ** t(kappa_db) * p
        eta_nr = eta_nr + t(eta_db) * a * g0t
        eta_ni = eta_ni + t(eta_db) * a * s0t
    # eta = eta_num / (gamma0 + i shift0)
    den = gamma0 * gamma0 + shift0 * shift0
    eta_r = (eta_nr * gamma0 + eta_ni * shift0) / den
    eta_i = (eta_ni * gamma0 - eta_nr * shift0) / den
    wa = torch.as_tensor(wing_abs, dtype=dt, device=dev)
    wing = torch.maximum(wa, torch.maximum(wing_hw * gamma0,
                                           wing_hw * lp.gamma_d))
    shape = lp.strength.shape
    full = lambda x: torch.broadcast_to(  # noqa: E731
        torch.as_tensor(x, dtype=dt, device=dev), shape)
    out = dict(strength=lp.strength, gamma_d=lp.gamma_d,
               gamma0=full(gamma0), shift0=full(shift0),
               gamma2=full(gamma2), shift2=full(shift2), nuvc=full(nuvc),
               eta_r=full(eta_r), eta_i=full(eta_i), wing=full(wing))
    if complex_dtype is not None:
        out["eta"] = torch.complex(out["eta_r"], out["eta_i"]).to(
            complex_dtype)
    return out


def _complex_of(dt):
    return torch.complex128 if dt == torch.float64 else torch.complex64


def xsect_ht(grid: torch.Tensor, lines, iso, T, p_atm, diluent=None,
             extras=None, wing_abs: float = 0.0, wing_hw: float = 50.0,
             chunk: int = 128) -> torch.Tensor:
    """The HT cross-section (nX,) [cm^2/molec] at one (T [K], p [atm]) on
    the ``grid`` tensor by the reference engine: hapi's column fallbacks
    per diluent (default ``{'air': 1}``; ``extras`` the HT columns), then
    :func:`ht_xsect_from_params`. A NumPy ``grid`` joins the store's
    device."""
    grid, = arrays_on(grid, device=lines.sw.device)
    resolved = resolve_ht_columns(lines, extras, diluent or {"air": 1.0})
    prm = ht_params(resolved, lines, iso, T, p_atm, wing_abs=wing_abs,
                    wing_hw=wing_hw, complex_dtype=_complex_of(grid.dtype))
    return ht_xsect_from_params(grid, lines.nu0, prm, chunk=chunk)


def ht_xsect_from_params(grid: torch.Tensor, nu0, prm: dict, chunk=128,
                         strength_scale=None) -> torch.Tensor:
    """The line sum (nX,) of pcqsdhc over chunks of ``chunk`` lines from an
    :func:`ht_params` dict of (L,) columns (with the complex ``eta`` of
    ``complex_dtype``), each line masked to its window
    nu0 - wing < g <= nu0 + wing (hapi's); ``strength_scale`` multiplies
    the strengths (the layered OD passes the species column density).
    NumPy ``grid``, ``nu0`` and ``strength_scale`` join ``prm``'s device."""
    grid, nu0, strength_scale = arrays_on(
        grid, nu0, strength_scale, device=prm["strength"].device)
    strength = prm["strength"]
    if strength_scale is not None:
        strength = strength * strength_scale
    cols = (nu0, strength, prm["gamma_d"], prm["gamma0"], prm["gamma2"],
            prm["shift0"], prm["shift2"], prm["nuvc"], prm["eta"],
            prm["wing"])
    g = grid[None, :]
    acc = torch.zeros_like(grid)
    for lo in live_chunks(grid, nu0, prm["wing"], chunk):
        nu0c, sc, gdc, g0c, g2c, s0c, s2c, nvcc, etac, wc = (
            c[lo:lo + chunk, None] for c in cols)
        vals = pcqsdhc(nu0c, gdc, g0c, g2c, s0c, s2c, nvcc, etac, g)[0]
        mask = (g > nu0c - wc) & (g <= nu0c + wc)
        acc = acc + torch.where(mask, sc * vals, 0.0).sum(dim=0)
    return acc
