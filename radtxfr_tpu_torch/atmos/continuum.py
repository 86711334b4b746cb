"""Continuum absorption: additive models, MT_CKD-class default
(counterpart of ``radtxfr_tpu/atmos/continuum.py``: the packaged
water-vapour tables, :func:`continuum_od` with the pointwise models of
:data:`CONTINUUM_MODELS` and :func:`register_continuum`,
:func:`make_layered_mt_ckd` and :func:`check_h2o_table_coverage`).

The 'mt_ckd' composite of the reference's LBLRTM ``ICNTNM=6`` production
setup (``radiative_transfer.py:591-601,622``): the table-driven H2O
self+foreign continuum in MT_CKD's formulation (two-table exponential
temperature law), the constructed CO2 far-wing continuum
(:mod:`.far_wing`), N2/O2 collision-induced bands and Rayleigh, with the
7-element TAPE5 record-1.2a scale factors ``cf``; 'none' (hapi parity),
'h2o_empirical' (Roberts et al. 1976), 'rayleigh' and 'empirical' (the
two). The H2O tables are the JAX package's literature-anchored
reconstruction (see its module docstring for provenance);
:func:`load_mt_ckd_tables` reads AER's coefficient file and
:func:`set_h2o_tables` installs it (or any other tables) for every
'mt_ckd' evaluation that follows, pointwise and layered.

The pointwise models take the layers as a batch dimension written out:
``fn(nu, T, p_pa, vmr, mol_ids, pl_km, cf)`` with ``nu`` (nX,), ``T``,
``p_pa`` and ``pl_km`` (nLay, 1), ``vmr`` (nLay, nM) returns the
(nLay, nX) OD, the JAX models' per-layer forms under ``vmap``.
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import torch

from .. import resolve_device
from ..core.constants import (BARYE_PER_ATM, CM_PER_KM, K_BOLTZMANN_CGS,
                              PA_PER_ATM)

__all__ = ["H2OContinuumTables", "H2O_CONTINUUM_LWIR", "continuum_od",
           "register_continuum", "CONTINUUM_MODELS", "make_layered_mt_ckd",
           "LAYERED_CONTINUUM_FACTORIES", "check_h2o_table_coverage",
           "set_h2o_tables", "load_mt_ckd_tables"]


@dataclasses.dataclass(frozen=True)
class H2OContinuumTables:
    """Water-vapor continuum coefficient tables (MT_CKD formulation).

    ``cs296``/``cs260`` are the self-continuum coefficients at the two MT_CKD
    reference temperatures, ``cf`` the (temperature-independent) foreign
    coefficient; all in cm^2 molec^-1 atm^-1 on the ``nu`` [cm^-1] grid.
    """

    nu: np.ndarray
    cs296: np.ndarray
    cs260: np.ndarray
    cf: np.ndarray

    def __post_init__(self):
        for f in ("nu", "cs296", "cs260", "cf"):
            object.__setattr__(self, f, np.asarray(getattr(self, f), dtype=np.float64))
        if not (self.nu.shape == self.cs296.shape == self.cs260.shape == self.cf.shape):
            raise ValueError("table columns must share one shape")
        if np.any(np.diff(self.nu) <= 0):
            raise ValueError("nu grid must be strictly increasing")


# Anchor grid (cm^-1) and coefficients (cm^2 molec^-1 atm^-1), 296 K.
# Self: log-space anchors through the published LWIR window values —
# exponential fall through the window (Burch & Alt 1984: ~2.0e-22 at
# 944 cm^-1; ~1.55e-22 at 1000 cm^-1), rising into the pure-rotation band
# below 700 and the nu2 band above 1300. Foreign: window floor ~1e-25 near
# 1000 cm^-1, orders of magnitude up at both band edges (MT_CKD window
# shape, Mlawer et al. 2012 Fig. 3).
#
# Above 1600 cm^-1 (round-3 verdict: the table silently clamped there
# while the engine advertises 400-7100) the anchors continue through the
# nu2 band tail, the 4 um (2400-2600) window, the nu1/nu3 band
# (3600-3900), the 2.1 um (4700) and 1.6 um (6000) windows, and the
# 5300 cm^-1 band, at the magnitudes of the published measurements:
# Burch & Alt (1984) and Baranov & Vigasin for the 4 um window
# (~4-10e-24 with strong negative T-dependence), CAVIAR (Ptashnik et
# al. 2011 JGR 116, D16305) for the near-IR windows, with the MT_CKD
# 3.x values (Mlawer et al. 2012) as the lower envelope. Stated
# uncertainty: ~25% through the LWIR window and band regions, factor
# ~2 in the 4 um window, factor ~3-5 in the 2.1/1.6 um windows where
# CAVIAR exceeds MT_CKD by that much (anchors sit between them).
_ANCHOR_NU = np.array([
    400.0, 450.0, 500.0, 550.0, 600.0, 650.0, 700.0, 750.0, 800.0,
    850.0, 900.0, 944.0, 1000.0, 1060.0, 1100.0, 1150.0, 1200.0,
    1250.0, 1300.0, 1350.0, 1400.0, 1450.0, 1500.0, 1600.0,
    1700.0, 1800.0, 1900.0, 2000.0, 2100.0, 2200.0, 2300.0, 2400.0,
    2500.0, 2600.0, 2800.0, 3000.0, 3200.0, 3400.0, 3600.0, 3750.0,
    3900.0, 4100.0, 4400.0, 4700.0, 5000.0, 5150.0, 5300.0, 5600.0,
    6000.0, 6300.0, 6600.0, 7000.0, 7100.0,
])
_ANCHOR_CS296 = np.array([
    4.0e-20, 2.0e-20, 8.5e-21, 4.4e-21, 2.4e-21, 1.4e-21, 8.0e-22,
    5.9e-22, 4.4e-22, 3.3e-22, 2.5e-22, 2.0e-22, 1.55e-22, 1.25e-22,
    1.05e-22, 9.0e-23, 8.0e-23, 8.2e-23, 1.0e-22, 1.6e-22, 2.8e-22,
    5.0e-22, 9.0e-22, 2.6e-21,
    3.0e-21, 1.3e-21, 3.0e-22, 6.0e-23, 2.0e-23, 1.3e-23, 1.0e-23,
    8.0e-24, 4.5e-24, 3.5e-24, 1.0e-23, 5.0e-23, 2.0e-22, 8.0e-22,
    2.0e-21, 3.0e-21, 1.5e-21, 2.0e-22, 8.0e-24, 8.0e-25, 2.0e-24,
    2.0e-23, 8.0e-23, 2.0e-23, 2.5e-25, 4.0e-25, 1.0e-24, 1.0e-23,
    2.0e-23,
])
# Self temperature exponent T0 [K] in exp(T0*(1/T - 1/296)): ~1800 in the
# window (Roberts et al. 1976; Burch), relaxing toward ~800 inside the bands
# where the continuum tracks the local line strengths more weakly. The 4 um
# window carries the strongest measured T-dependence (Baranov & Vigasin).
_ANCHOR_T0 = np.array([
    800.0, 900.0, 1000.0, 1150.0, 1300.0, 1500.0, 1700.0, 1800.0, 1800.0,
    1800.0, 1800.0, 1800.0, 1800.0, 1800.0, 1800.0, 1750.0, 1700.0,
    1600.0, 1450.0, 1250.0, 1050.0, 900.0, 850.0, 800.0,
    800.0, 900.0, 1100.0, 1400.0, 1600.0, 1800.0, 1900.0, 2000.0,
    2000.0, 2000.0, 1700.0, 1400.0, 1100.0, 900.0, 800.0, 800.0,
    900.0, 1200.0, 1600.0, 1800.0, 1500.0, 1100.0, 900.0, 1200.0,
    1700.0, 1600.0, 1400.0, 1000.0, 900.0,
])
_ANCHOR_CF = np.array([
    6.0e-23, 3.0e-23, 1.5e-23, 7.0e-24, 3.5e-24, 1.8e-24, 9.0e-25,
    5.0e-25, 3.0e-25, 2.0e-25, 1.4e-25, 1.1e-25, 1.0e-25, 1.1e-25,
    1.3e-25, 1.8e-25, 2.8e-25, 5.0e-25, 1.2e-24, 3.5e-24, 1.0e-23,
    2.5e-23, 5.0e-23, 1.5e-22,
    1.2e-22, 3.0e-23, 5.0e-24, 8.0e-25, 1.5e-25, 5.0e-26, 3.0e-26,
    2.5e-26, 2.0e-26, 2.5e-26, 1.0e-25, 6.0e-25, 3.0e-24, 1.0e-23,
    2.5e-23, 3.0e-23, 1.0e-23, 8.0e-25, 4.0e-26, 1.5e-26, 5.0e-26,
    8.0e-25, 3.0e-24, 3.0e-25, 1.0e-26, 2.0e-26, 8.0e-26, 8.0e-25,
    1.5e-24,
])

#: Packaged literature-anchored LWIR water-continuum tables (see module doc).
H2O_CONTINUUM_LWIR = H2OContinuumTables(
    nu=_ANCHOR_NU,
    cs296=_ANCHOR_CS296,
    cs260=_ANCHOR_CS296 * np.exp(_ANCHOR_T0 * (1.0 / 260.0 - 1.0 / 296.0)),
    cf=_ANCHOR_CF,
)

_ACTIVE_H2O_TABLES = H2O_CONTINUUM_LWIR


def set_h2o_tables(tables: H2OContinuumTables) -> None:
    """Install replacement water-continuum tables (e.g. real MT_CKD data
    loaded via :func:`load_mt_ckd_tables`) for the ``'mt_ckd'`` model:
    the pointwise model, :func:`make_layered_mt_ckd` and
    :func:`check_h2o_table_coverage` read them at call time."""
    global _ACTIVE_H2O_TABLES
    _ACTIVE_H2O_TABLES = tables


def load_mt_ckd_tables(path: str, radiation_temperature: float = 296.0
                       ) -> H2OContinuumTables:
    """Load AER's MT_CKD water-vapor coefficient file
    (``absco-ref_wv-mt-ckd.nc``, netCDF4/HDF5; openly licensed at
    github.com/AER-RC/MT_CKD).

    The native tables store radiation-term-free coefficients C~ in
    cm^3/molec; the absorption used here multiplies by the radiation term
    nu*tanh(h c nu / 2 k T) and by the reference density n0 = p0/(k T0),
    converting to the measured-coefficient convention (cm^2 molec^-1
    atm^-1) of this module. The foreign table is converted at
    ``radiation_temperature``. Each column binds the first exact dataset
    name it finds, else the one dataset whose lowercased name holds all of
    its substrings (with a warning naming the binding); else ``KeyError``.
    """
    import h5py

    with h5py.File(path, "r") as f:
        names = set(f.keys())

        def pick(*cands, substr=None):
            for c in cands:
                if c in names:
                    return np.asarray(f[c][...], dtype=np.float64).ravel()
            if substr:
                hits = [n for n in names
                        if all(t in n.lower() for t in substr)]
                if len(hits) == 1:
                    warnings.warn(
                        f"load_mt_ckd_tables: no exact match among {cands}; "
                        f"fuzzily bound dataset {hits[0]!r} (substrings "
                        f"{substr})", stacklevel=3)
                    return np.asarray(f[hits[0]][...],
                                      dtype=np.float64).ravel()
            raise KeyError(f"none of {cands} (or unique match for "
                           f"{substr}) in {sorted(names)}")

        nu = pick("wavenumbers", "wavenumber", "wvn", "wnum",
                  substr=("wavenumber",))
        cs296 = pick("self_absco_ref", "self_continuum", "cs296",
                     substr=("self", "ref"))
        cs260 = pick("self_absco_260", "cs260", substr=("self", "260"))
        cf = pick("for_absco_ref", "foreign_continuum", "cf296",
                  substr=("for", "absco"))
        t_self = 296.0
        if "ref_temp" in names:
            t_self = float(np.asarray(f["ref_temp"][...]).ravel()[0])

    c2 = 1.4387768775039337  # hc/k [cm K]

    def n0(T):               # molec/cm^3 per atm
        return BARYE_PER_ATM / (K_BOLTZMANN_CGS * T)

    def rad(T):
        return nu * np.tanh(0.5 * c2 * nu / T)

    return H2OContinuumTables(
        nu=nu,
        cs296=cs296 * rad(t_self) * n0(t_self),
        cs260=cs260 * rad(260.0) * n0(260.0),
        cf=cf * rad(radiation_temperature) * n0(radiation_temperature),
    )


def _interp(x, xp, fp):
    """Piecewise-linear interpolation of ``fp`` (..., n) at ``x`` (nX,),
    held constant beyond the ends (``jnp.interp``'s formula):
    (..., nX)."""
    i = torch.clamp(torch.searchsorted(xp, x, right=True), 1, xp.numel() - 1)
    lo, hi = fp[..., i - 1], fp[..., i]
    f = lo + ((x - xp[i - 1]) / (xp[i] - xp[i - 1])) * (hi - lo)
    f = torch.where(x < xp[0], fp[..., :1], f)
    return torch.where(x > xp[-1], fp[..., -1:], f)


def _interp_log(nu, table_nu, table_c):
    """Log-space linear interpolation (coefficients vary exponentially)."""
    t = lambda a: torch.as_tensor(a, dtype=nu.dtype, device=nu.device)
    return torch.exp(_interp(nu, t(table_nu), torch.log(t(table_c))))


def _n_h2o(T, p_pa, x):
    """H2O number density [molec/cm^3]."""
    p_barye = (p_pa / PA_PER_ATM) * BARYE_PER_ATM
    return x * p_barye / (K_BOLTZMANN_CGS * T)


def _mol_x(vmr, mol_ids, mol):
    """The (nLay, 1) vmr column of HITRAN molecule ``mol``, or None."""
    mol_ids = tuple(mol_ids)
    return vmr[:, mol_ids.index(mol), None] if mol in mol_ids else None


def _zeros(nu, T):
    return torch.zeros((T.shape[0], nu.shape[0]), dtype=nu.dtype,
                       device=nu.device)


def _mt_ckd_h2o(nu, T, p_pa, vmr, mol_ids, pl_km, cf):
    """Table-driven H2O self+foreign continuum (MT_CKD formulation)."""
    x = _mol_x(vmr, mol_ids, 1)
    if x is None:
        return _zeros(nu, T)
    tab = _ACTIVE_H2O_TABLES
    cs296 = _interp_log(nu, tab.nu, tab.cs296)
    cs260 = _interp_log(nu, tab.nu, tab.cs260)
    cfor = _interp_log(nu, tab.nu, tab.cf)
    # MT_CKD two-table exponential temperature inter/extrapolation
    cs = cs296 * (cs260 / cs296) ** ((296.0 - T) / 36.0)
    return _self_foreign_od(cs, cfor, x, T, p_pa, pl_km, cf)


def _self_foreign_od(cs, cfor, x, T, p_pa, pl_km, cf):
    """H2O continuum OD (TAPE5 slots 1 and 2) from the self and foreign
    coefficients ``cs`` and ``cfor`` [cm^2 molec^-1 atm^-1] at the water
    column ``x``: (cs e + cfor (p - e)) n_H2O path, e = x p."""
    p_atm = p_pa / PA_PER_ATM
    e_atm = x * p_atm
    k = cs * cf[0] * e_atm + cfor * cf[1] * (p_atm - e_atm)
    return k * _n_h2o(T, p_pa, x) * pl_km * CM_PER_KM


def _zero(nu, T, p_pa, vmr, mol_ids, pl_km, cf):
    return _zeros(nu, T)


def _h2o_empirical(nu, T, p_pa, vmr, mol_ids, pl_km, cf):
    """Closed-form Roberts/Selby/Biberman (1976) LWIR H2O continuum:
    C_s(nu, 296 K) = a + b exp(-beta nu), a = 4.18, b = 5578 cm^2 g^-1
    atm^-1, beta = 7.87e-3 cm, per molecule; exp(T0 (1/T - 1/296)) with
    T0 = 1800 K; foreign fraction 0.002 of the 296 K self coefficient."""
    x = _mol_x(vmr, mol_ids, 1)
    if x is None:
        return _zeros(nu, T)
    g_per_molec = 18.015 / 6.02214076e23
    a, b, beta = 4.18 * g_per_molec, 5578.0 * g_per_molec, 7.87e-3
    To = 1800.0
    cs296 = a + b * torch.exp(-beta * nu)
    cs = cs296 * torch.exp(To * (1.0 / T - 1.0 / 296.0))
    return _self_foreign_od(cs, 0.002 * cs296, x, T, p_pa, pl_km, cf)


def _rayleigh_sigma(nu):
    """The long-wavelength molecular scattering cross-section [cm^2]
    24 pi^3 nu^4 / N_s^2 ((n^2-1)/(n^2+2))^2 F_k (Bodhaine et al. 1999),
    regrouped as (nu^2/N_s)^2 so that float32 does not overflow; ``nu`` a
    NumPy array or a tensor."""
    n_s = 2.546899e19            # molec/cm^3 at 288.15 K, 1013.25 hPa
    n_ref = 1.0 + 2.79e-4        # dry air, long-wavelength limit
    f_k = 1.061
    lorentz = (n_ref**2 - 1.0) / (n_ref**2 + 2.0)
    return 24.0 * np.pi**3 * (nu * nu / n_s)**2 * lorentz**2 * f_k


def _rayleigh_od(sigma, T, p_pa, pl_km, cf):
    """Rayleigh extinction OD (TAPE5 slot 7) of the cross-section
    ``sigma``."""
    n_air = (p_pa * 10.0) / (K_BOLTZMANN_CGS * T)   # molec/cm^3 (Pa->barye)
    return cf[6] * sigma * n_air * pl_km * CM_PER_KM


def _rayleigh(nu, T, p_pa, vmr, mol_ids, pl_km, cf):
    """Rayleigh extinction OD (TAPE5 slot 7)."""
    return _rayleigh_od(_rayleigh_sigma(nu), T, p_pa, pl_km, cf)


def _co2_farwing(nu, T, p_pa, vmr, mol_ids, pl_km, cf):
    """CO2 nu2-wing continuum (TAPE5 slot 3) from the chi-corrected
    far-wing table (:func:`.far_wing.co2_continuum_table`), linear in T
    between its rows."""
    x = _mol_x(vmr, mol_ids, 2)
    if x is None:
        return _zeros(nu, T)
    from .far_wing import co2_continuum_table

    t = lambda a: torch.as_tensor(a, dtype=nu.dtype, device=nu.device)
    nu_tab, t_tab, c_tab = (t(a) for a in co2_continuum_table())
    c = _interp(nu, nu_tab, _co2_rows(T[:, 0], t_tab, c_tab))
    return _co2_od(c, x, T, p_pa, pl_km, cf)


def _co2_rows(T, t_tab, c_tab):
    """The far-wing table's rows ``c_tab`` (nT, n) at the layers' ``T``
    (nLay,), linear in T between the rows ``t_tab`` and held at the ends:
    (nLay, n)."""
    i = torch.clamp(torch.searchsorted(t_tab, T) - 1, 0, t_tab.numel() - 2)
    w = torch.clamp((T - t_tab[i]) / (t_tab[i + 1] - t_tab[i]), 0.0,
                    1.0)[:, None]
    return (1.0 - w) * c_tab[i] + w * c_tab[i + 1]


def _co2_od(c, x, T, p_pa, pl_km, cf):
    """CO2 continuum OD (TAPE5 slot 3) of the coefficient ``c`` [cm^2
    molec^-1 atm^-1] at the CO2 column ``x``."""
    p_atm = p_pa / PA_PER_ATM
    n_co2 = x * p_atm * BARYE_PER_ATM / (K_BOLTZMANN_CGS * T)
    return cf[2] * c * n_co2 * p_atm * pl_km * CM_PER_KM


def _cia(nu, T, p_pa, vmr, mol_ids, pl_km, cf):
    """N2 rototranslational + O2 fundamental collision-induced absorption
    (TAPE5 slots 6 and 5), amagat-squared density scaling."""
    from .far_wing import cia_n2_rototranslational, cia_o2_fundamental

    return _cia_od(cia_n2_rototranslational(nu, T),
                   cia_o2_fundamental(nu, T), T, p_pa, vmr, mol_ids, pl_km,
                   cf)


def _cia_od(c_n2, c_o2, T, p_pa, vmr, mol_ids, pl_km, cf):
    """CIA OD (TAPE5 slots 6 and 5) of the N2 and O2 coefficients [cm^-1
    amagat^-2], amagat-squared density scaling; the standard N2 and O2
    columns where the atmosphere carries none."""
    p_atm = p_pa / PA_PER_ATM
    rho_air = p_atm * (273.15 / T)                # amagat
    x_n2 = _mol_x(vmr, mol_ids, 22)
    x_o2 = _mol_x(vmr, mol_ids, 7)
    x_n2 = 0.7808 if x_n2 is None else x_n2
    x_o2 = 0.2095 if x_o2 is None else x_o2
    path_cm = pl_km * CM_PER_KM
    return ((cf[5] * c_n2 * x_n2 + cf[4] * c_o2 * x_o2)
            * rho_air * rho_air * path_cm)


def _mt_ckd(nu, T, p_pa, vmr, mol_ids, pl_km, cf):
    """The 'mt_ckd' production model: every TAPE5 record-1.2a slot but O3
    (slot 4, a UV/visible continuum with no LWIR term): H2O self+foreign
    tables, the CO2 far-wing continuum, O2/N2 CIA, Rayleigh."""
    return (_mt_ckd_h2o(nu, T, p_pa, vmr, mol_ids, pl_km, cf)
            + _co2_farwing(nu, T, p_pa, vmr, mol_ids, pl_km, cf)
            + _cia(nu, T, p_pa, vmr, mol_ids, pl_km, cf)
            + _rayleigh(nu, T, p_pa, vmr, mol_ids, pl_km, cf))


def _empirical(nu, T, p_pa, vmr, mol_ids, pl_km, cf):
    """Closed-form empirical terms (Roberts H2O + Rayleigh)."""
    return (_h2o_empirical(nu, T, p_pa, vmr, mol_ids, pl_km, cf)
            + _rayleigh(nu, T, p_pa, vmr, mol_ids, pl_km, cf))


#: the pointwise models by name (see the module docstring for their form)
CONTINUUM_MODELS = {
    "none": _zero,
    "mt_ckd": _mt_ckd,
    "h2o_empirical": _h2o_empirical,
    "rayleigh": _rayleigh,
    "empirical": _empirical,
}


def register_continuum(name: str, fn) -> None:
    """Register a model fn(nu, T, p_pa, vmr, mol_ids, pl_km, cf) -> OD,
    layers batched as in the module docstring."""
    CONTINUUM_MODELS[name] = fn


def continuum_factors_tensor(continuum_factors, model, dtype, device):
    """The 7 TAPE5 record-1.2a scale factors as a tensor (all ones by
    default); raises on another length and warns where 'mt_ckd' is given
    an O3 factor, whose slot it leaves at zero."""
    if continuum_factors is None:
        return torch.ones(7, dtype=dtype, device=device)
    cf_host = np.asarray(continuum_factors, dtype=np.float64)
    if cf_host.shape != (7,):
        raise ValueError(
            f"continuum_factors must have exactly 7 elements (TAPE5 record "
            f"1.2a convention), got shape {cf_host.shape}")
    if model == "mt_ckd" and cf_host[3] not in (0.0, 1.0):
        warnings.warn(
            "continuum_factors[3] scales the O3 continuum slot, which is "
            "zero in 'mt_ckd' (LBLRTM's O3 continuum is a UV/visible "
            "electronic term with no LWIR part): the factor has no effect",
            stacklevel=3)
    return torch.as_tensor(cf_host, dtype=dtype, device=device)


def continuum_od(nu, atmos, model: str = "none", continuum_factors=None):
    """Additive continuum OD (nLayers, nX) of a layered atmosphere by the
    pointwise model ``model``, on the device of ``atmos`` in the dtype of
    ``nu`` (an axis [cm^-1]); ``continuum_factors`` follows the
    reference's 7-element TAPE5 scale factors (all ones by default)."""
    fn = CONTINUUM_MODELS[model]
    dev = atmos.T.device
    nu = torch.as_tensor(nu, device=dev)
    if model == "mt_ckd":
        check_h2o_table_coverage(float(nu.min()), float(nu.max()))
    cf = continuum_factors_tensor(continuum_factors, model, nu.dtype, dev)
    col = lambda a: a.to(nu.dtype)[:, None]  # noqa: E731
    return fn(nu, col(atmos.T), col(atmos.p), atmos.vmr.to(nu.dtype),
              atmos.mol_ids, col(atmos.pl), cf)


def make_layered_mt_ckd(nu, mol_ids, device=None, dtype=torch.float32,
                        tables: H2OContinuumTables | None = None):
    """Layer-hoisted evaluator of the 'mt_ckd' composite.

    Every nu-only quantity (the log-interpolated H2O tables, the (T, nu)
    CO2 far-wing table, the O2 CIA Gaussian core, the Rayleigh sigma(nu))
    is computed once here in float64 on the host and kept on ``device``
    (None: the card) in ``dtype``; the returned
    ``fn(T, p_pa, pl_km, vmr, cf) -> (nLay, nX)``
    does one exp per (layer, point) for the H2O temperature law plus
    broadcast algebra; ``fn(..., k=idx)`` evaluates only the points ``idx``
    (int64 indices into ``nu``: a spectral shard's). The formulas of
    ``radtxfr_tpu.atmos.continuum.make_layered_mt_ckd``, each written once
    with the pointwise models (the OD helpers ``_self_foreign_od``,
    ``_co2_od``, ``_cia_od``, ``_rayleigh_od`` and the coefficients of
    :mod:`.far_wing`). ``tables`` None means the installed tables
    (:func:`set_h2o_tables`), read when this is called.
    """
    from .far_wing import (cia_n2_rototranslational, cia_o2_band,
                           cia_o2_gaussian, co2_continuum_table)

    device = resolve_device(device)
    nu_h = np.asarray(nu, dtype=np.float64)
    mol_ids = tuple(mol_ids)
    tables = _ACTIVE_H2O_TABLES if tables is None else tables
    tn = tables.nu
    L296 = np.interp(nu_h, tn, np.log(tables.cs296))
    dL = np.interp(nu_h, tn, np.log(tables.cs260)) - L296
    cfor = np.exp(np.interp(nu_h, tn, np.log(tables.cf)))
    nu_tab, t_tab, c_tab = co2_continuum_table()
    ctab = np.stack([np.interp(nu_h, nu_tab, r) for r in c_tab])
    d_o2, core_o2 = cia_o2_gaussian(nu_h)

    j = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    row = lambda a: j(a)[None, :]
    L296j, dLj, cforj = row(L296), row(dL), row(cfor)
    ctabj, t_tabj = j(ctab), j(t_tab)
    sigmaj, abs_nuj = row(_rayleigh_sigma(nu_h)), row(np.abs(nu_h))
    d_o2j, core_o2j = row(d_o2), row(core_o2)

    def fn(T, p_pa, pl_km, vmr, cf, k=None):
        def sel(a):
            return a if k is None else a[..., k]

        Tc, pc, plc = T[:, None], p_pa[:, None], pl_km[:, None]
        out = 0.0
        x = _mol_x(vmr, mol_ids, 1)
        if x is not None:
            cs = torch.exp(sel(L296j) + (296.0 - Tc) / 36.0 * sel(dLj))
            out = out + _self_foreign_od(cs, sel(cforj), x, Tc, pc, plc, cf)
        x = _mol_x(vmr, mol_ids, 2)
        if x is not None:
            out = out + _co2_od(_co2_rows(T, t_tabj, sel(ctabj)), x, Tc, pc,
                                plc, cf)
        out = out + _cia_od(cia_n2_rototranslational(sel(abs_nuj), Tc),
                            cia_o2_band(sel(d_o2j), sel(core_o2j), Tc), Tc,
                            pc, vmr, mol_ids, plc, cf)
        return out + _rayleigh_od(sel(sigmaj), Tc, pc, plc, cf)

    return fn


#: models with a layer-hoisted factory (nu, mol_ids, device, dtype) -> fn
LAYERED_CONTINUUM_FACTORIES = {"mt_ckd": make_layered_mt_ckd}


def check_h2o_table_coverage(nu_min: float, nu_max: float,
                             tables: H2OContinuumTables | None = None,
                             stacklevel: int = 3) -> None:
    """Warn when an evaluation range leaves the H2O continuum table
    (``tables``; None: the installed ones, :func:`set_h2o_tables`): the
    interpolation clamps at the table ends, a silently constant
    coefficient orders of magnitude off."""
    tables = _ACTIVE_H2O_TABLES if tables is None else tables
    lo, hi = float(tables.nu[0]), float(tables.nu[-1])
    if nu_min < lo - 1.0 or nu_max > hi + 1.0:
        warnings.warn(
            f"H2O continuum table covers {lo:.0f}-{hi:.0f} cm^-1 but the "
            f"evaluation spans {nu_min:.0f}-{nu_max:.0f}; coefficients "
            "are clamped (held constant) outside the table; install a "
            "wider table via set_h2o_tables/load_mt_ckd_tables",
            stacklevel=stacklevel)
