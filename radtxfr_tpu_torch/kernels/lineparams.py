"""Per-line thermodynamic parameters (counterpart of
``radtxfr_tpu/kernels/lineparams.py``).

hapi's Voigt driver (``misc/hapi.py:11050-11138``, env dependences
``:10169-10200``):

* S(T) = S_ref Q(Tref)/Q(T) exp(-c2 E''/T)(1 - exp(-c2 nu0/T)) / [same at Tref]
* gamma_D = nu0 sqrt(2 k_B T ln2 / m c^2), m in grams
* gamma_0 = (p/pref)(Tref/T)^n_air ((1 - x_self) gamma_air + x_self gamma_self)
* shift0 = (1 - x_self) delta_air p/pref
* wing = max(wing_abs, wing_hw gamma_0, wing_hw gamma_D)
* gamma_2 = (1 - x_self) sd_air gamma_air p/pref (SD-Voigt, ``:10870-10876``)

and the other drivers' rules by ``profile``: the Doppler driver's SI
constants and its shift without the diluent mix (``:11534-11545``), the
Lorentz wing without the Doppler term (``:11364``) and the Doppler wing
without the collisional one (``:11541``); SD-Voigt evaluates its profile
at the unshifted centre and carries the shift inside it (``:10890``).

Thermodynamic inputs broadcast against the (L,) line columns: pass
(nLay, 1) tensors for T, p and (nLay, L) for the per-line terms to get the
(nLay, L) parameters of every layer in one call.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import arrays_on
from ..core.constants import (C2_CM_K, C_LIGHT_CGS, C_MASS_MOL,
                              K_BOLTZMANN_CGS, P_REF, SQRT_2LN2, T_REF)
from ..lines.store import IsoTables, LineStore
from ..lines.tips import partition_sum

__all__ = ["LineParams", "compute_line_params"]


@dataclasses.dataclass(frozen=True)
class LineParams:
    """Kernel-ready per-line parameters (shape (..., L))."""

    nu0: torch.Tensor          # unshifted line center [cm^-1] (wing window)
    nu0_shifted: torch.Tensor  # pressure-shifted center [cm^-1] (profile)
    strength: torch.Tensor     # scaled intensity (incl. column density)
    gamma_d: torch.Tensor      # Doppler HWHM [cm^-1]
    gamma_0: torch.Tensor      # collisional HWHM [cm^-1]
    wing: torch.Tensor         # wing cutoff [cm^-1]
    gamma_2: torch.Tensor      # speed-dependent width [cm^-1] (SD-Voigt)
    shift0: torch.Tensor       # pressure shift [cm^-1]


def compute_line_params(lines: LineStore, iso: IsoTables, T, p_atm,
                        vmr_self=0.0, wing_abs=0.0, wing_hw=50.0,
                        strength_scale=1.0, abundance_ratio=1.0,
                        profile: str = "voigt") -> LineParams:
    """Evaluate per-line parameters at (T [K], p [atm]) by the rules of
    ``profile``'s driver ('voigt', 'sdvoigt', 'lorentz' or 'doppler').
    ``abundance_ratio`` (scalar or (L,)) is the ABUNDANCES /
    NATURAL_ABUNDANCES factor folded into the strength (1 for natural
    abundance, ``misc/hapi.py:11136-11137``)."""
    T = torch.as_tensor(T, dtype=lines.sw.dtype, device=lines.sw.device)
    p = torch.as_tensor(p_atm, dtype=T.dtype, device=T.device)
    # NumPy factors join the store's device in its dtype (tensors and
    # scalars as given)
    vmr_self, strength_scale = arrays_on(vmr_self, strength_scale,
                                         device=T.device, dtype=T.dtype)

    # Q(T) once per isotopologue (a ~143-row table), gathered per line
    all_rows = torch.arange(iso.q.shape[0], device=iso.q.device)
    out_shape = torch.broadcast_shapes(T.shape, lines.iso_row.shape)
    q_t = partition_sum(iso.q, all_rows[None, :], T.reshape(-1, 1))[
        :, lines.iso_row].reshape(out_shape)
    q_ref = partition_sum(iso.q, all_rows,
                          torch.tensor(T_REF, dtype=T.dtype,
                                       device=T.device))[lines.iso_row]
    c2 = C2_CM_K
    ch = (torch.exp(-c2 * lines.elower / T)
          * (1.0 - torch.exp(-c2 * lines.nu0 / T)))
    zn = (torch.exp(-c2 * lines.elower / T_REF)
          * (1.0 - torch.exp(-c2 * lines.nu0 / T_REF)))
    ar = torch.as_tensor(abundance_ratio, dtype=T.dtype, device=T.device)
    strength = lines.sw * (q_ref / q_t) * (ch / zn) * ar * strength_scale

    if profile == "doppler":
        # the Doppler driver's SI constants and sqrt-mass factorisation
        c_si = 2.99792458e8
        k_si = 1.3806503e-23
        gamma_d = ((SQRT_2LN2 / c_si) * float(np.sqrt(k_si / C_MASS_MOL))
                   * torch.sqrt(T) * lines.nu0
                   / torch.sqrt(iso.molar_mass[lines.iso_row]))
    else:
        mass_g = iso.molar_mass[lines.iso_row] * C_MASS_MOL * 1000.0
        gamma_d = (torch.sqrt(2.0 * K_BOLTZMANN_CGS * T * np.log(2.0)
                              / mass_g / C_LIGHT_CGS**2) * lines.nu0)

    x_self = vmr_self
    t_pow = (T_REF / T) ** lines.n_air    # n_self falls back to n_air (.par)
    gamma_0 = (p / P_REF) * t_pow * (
        (1.0 - x_self) * lines.gamma_air + x_self * lines.gamma_self)
    if profile == "doppler":
        shift0 = lines.delta_air * (p / P_REF)    # no diluent mix
    else:
        shift0 = (1.0 - x_self) * lines.delta_air * (p / P_REF)

    wa = torch.as_tensor(wing_abs, dtype=T.dtype, device=T.device)
    if profile == "lorentz":
        wing = torch.maximum(wa, wing_hw * gamma_0)
    elif profile == "doppler":
        wing = torch.maximum(wa, wing_hw * gamma_d)
    else:
        wing = torch.maximum(
            torch.maximum(wing_hw * gamma_0, wing_hw * gamma_d), wa)
    # the unscaled reference gamma, no T-power; .par has no SD_self column
    gamma_2 = (1.0 - x_self) * lines.sd_air * lines.gamma_air * (p / P_REF)
    shifted = lines.nu0 if profile == "sdvoigt" else lines.nu0 + shift0
    return LineParams(
        nu0=torch.broadcast_to(lines.nu0, strength.shape),
        nu0_shifted=torch.broadcast_to(shifted, strength.shape),
        strength=strength,
        gamma_d=gamma_d,
        gamma_0=gamma_0,
        wing=wing,
        shift0=shift0,
        gamma_2=gamma_2,
    )
