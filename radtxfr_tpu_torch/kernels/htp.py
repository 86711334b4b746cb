"""Hartmann-Tran profile (pCqSDHC) family on complex tensors (counterpart
of ``radtxfr_tpu/kernels/htp.py``), the reference engine's HT and SD-Voigt
line shape.

hapi's ``pcqsdhc`` (``misc/hapi.py:9850-10023``; Tran, Ngo & Hartmann,
JQSRT 129 (2013) 199) with every part evaluated at every point and the
point's part chosen with ``torch.where`` (compute and select), so it runs
over (lines x wavenumbers) blocks:

* PART1 (``|c2t| == 0``, per line): the Voigt-like term (``:9910-9921``),
  its |Z1| > 4e3 asymptotic branch applied pointwise;
* otherwise per point PART2 (``|X| <= 3e-8 |Y|``), PART3
  (``|Y| <= 1e-15 |X|``, its small-|sqrt X| branch on the same points) or
  PART4, with PART4's CPF3-against-CPF choice (``:9930-9968``).

The two divergences from hapi and the guards against lanes that are not
selected are the JAX module's. Complex quantities are complex64 for
float32 inputs and complex128 for float64; integer powers are written as
products. :mod:`.htp_real` is the same function in real pairs (the plain
version of the HT kernels).
"""

from __future__ import annotations

import math

import torch

from .. import arrays_on
from .faddeeva import wofz_real

__all__ = ["pcqsdhc", "profile_ht", "profile_sdvoigt", "profile_sdrautian",
           "profile_rautian"]

_RPI = math.sqrt(math.pi)
_SQRT_LN2 = math.sqrt(math.log(2.0))
_TT = (0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5, 8.5, 9.5, 10.5, 11.5, 12.5,
       13.5, 14.5)


def _w_of(Z):
    """hapi's CPF convention: w at (x, y) = (-Im Z, Re Z), by hum1_wei."""
    wr, wi = wofz_real(-Z.imag, Z.real)
    return torch.complex(wr, wi)


def _cpf3_of(Z):
    """The 15-term asymptotic CPF (``cpf3``, ``misc/hapi.py:9645-9670``) at
    (x, y) = (-Im Z, Re Z)."""
    z = torch.complex(-Z.imag, Z.real)
    zm1 = 1.0 / z
    zm2 = zm1 * zm1
    zsum = torch.ones_like(z)
    zterm = torch.ones_like(z)
    for tt_i in _TT:
        zterm = zterm * zm2 * tt_i
        zsum = zsum + zterm
    return zsum * 1j * zm1 * (1.0 / _RPI)


def pcqsdhc(sg0, gamma_d, gamma0, gamma2, shift0, shift2, anuvc, eta, sg,
            device=None):
    """The complex-normalized pCqSDHC line shape, branchless.

    Every parameter broadcasts against ``sg`` (the wavenumber axis, a
    tensor); ``eta`` may be complex (the HT driver's correlation
    parameter). NumPy arguments join a tensor argument's device, else
    ``device`` (None: the card). Returns the (real, imaginary) parts [cm],
    hapi's return convention.
    """
    sg, sg0, gamma_d, gamma0, gamma2, shift0, shift2, anuvc, eta = arrays_on(
        sg, sg0, gamma_d, gamma0, gamma2, shift0, shift2, anuvc, eta,
        device=device, lead=True)
    dev = sg.device
    dt = torch.promote_types(sg.dtype, torch.float32)
    if isinstance(gamma_d, torch.Tensor):
        dt = torch.promote_types(dt, gamma_d.dtype)
    cdt = torch.complex128 if dt == torch.float64 else torch.complex64
    c = lambda a: torch.as_tensor(a, dtype=dt, device=dev)  # noqa: E731
    sg = sg.to(dt)
    sg0, gamma_d, gamma0, gamma2, shift0, shift2, anuvc = map(
        c, (sg0, gamma_d, gamma0, gamma2, shift0, shift2, anuvc))
    cplx = (eta.is_complex() if isinstance(eta, torch.Tensor)
            else isinstance(eta, complex))
    eta = torch.as_tensor(eta, dtype=cdt if cplx else dt, device=dev)

    cte = _SQRT_LN2 / gamma_d
    c0 = torch.complex(gamma0, shift0)
    c2 = torch.complex(gamma2, shift2)
    c0t = (1.0 - eta) * (c0 - 1.5 * c2) + anuvc
    c2t = (1.0 - eta) * c2

    part1 = torch.abs(c2t) == 0.0

    # PART1: |c2t| == 0 (the Voigt / Rautian limit)
    Z1a = (1j * (sg0 - sg) + c0t) * cte
    w1a = _w_of(Z1a)
    A1 = _RPI * cte * w1a
    B1_small = _RPI * cte * ((1.0 - Z1a * Z1a) * w1a + Z1a / _RPI)
    # the 1/Z1 asymptotic form, guarded at Z1 ~ 0 (chosen where |Z1| > 4e3)
    Z1a_safe = torch.where(torch.abs(Z1a) > 1e-30, Z1a, 1.0)
    B1_big = cte * (_RPI * w1a + 0.5 / Z1a_safe
                    - 0.75 / (Z1a_safe * Z1a_safe * Z1a_safe))
    B1 = torch.where(torch.abs(Z1a) <= 4.0e3, B1_small, B1_big)

    # PART2/3/4
    c2t_safe = torch.where(part1, 1.0, c2t)
    X = (1j * (sg0 - sg) + c0t) / c2t_safe
    y_root = 1.0 / (2.0 * cte * c2t_safe)
    Y = y_root * y_root
    g2s2 = gamma2 * gamma2 + shift2 * shift2
    g2s2_safe = torch.where(g2s2 == 0.0, 1.0, g2s2)
    eta_safe = torch.where(eta == 1.0, 0.0, eta)
    csqrtY = (torch.complex(gamma2, -shift2)
              / (2.0 * cte * (1.0 - eta_safe) * g2s2_safe))

    absX = torch.abs(X)
    absY = torch.abs(Y)
    part2 = ~part1 & (absX <= 3.0e-8 * absY)
    part3 = ~part1 & ~part2 & (absY <= 1.0e-15 * absX)

    sXY = torch.sqrt(X + Y)
    csqrtY_safe = torch.where(torch.abs(csqrtY) == 0.0, 1.0, csqrtY)

    # PART4 (the main part)
    Z1 = sXY - csqrtY
    Z2 = Z1 + 2.0 * csqrtY
    SZ1 = torch.sqrt(Z1.imag * Z1.imag + Z1.real * Z1.real)
    SZ2 = torch.sqrt(Z2.imag * Z2.imag + Z2.real * Z2.real)
    DSZ = torch.abs(SZ1 - SZ2)
    SZmx = torch.maximum(SZ1, SZ2)
    SZmn = torch.minimum(SZ1, SZ2)
    use_cpf3 = (DSZ <= 1.0) & (SZmx > 8.0) & (SZmn <= 8.0)
    w1_4 = torch.where(use_cpf3, _cpf3_of(Z1), _w_of(Z1))
    w2_4 = torch.where(use_cpf3, _cpf3_of(Z2), _w_of(Z2))
    A4 = _RPI * cte * (w1_4 - w2_4)
    B4 = (-1.0
          + _RPI / (2.0 * csqrtY_safe) * (1.0 - Z1 * Z1) * w1_4
          - _RPI / (2.0 * csqrtY_safe) * (1.0 - Z2 * Z2) * w2_4) / c2t_safe

    # PART2 (|X| << |Y|)
    Z1b = (1j * (sg0 - sg) + c0t) * cte
    Z2b = sXY + csqrtY
    w1_2 = _w_of(Z1b)
    w2_2 = _w_of(Z2b)
    A2 = _RPI * cte * (w1_2 - w2_2)
    B2 = (-1.0
          + _RPI / (2.0 * csqrtY_safe) * (1.0 - Z1b * Z1b) * w1_2
          - _RPI / (2.0 * csqrtY_safe) * (1.0 - Z2b * Z2b) * w2_2) / c2t_safe

    # PART3 (|Y| << |X|)
    wXY = _w_of(sXY)
    sX = torch.sqrt(X)
    wX = _w_of(sX)
    A3_small = (2.0 * _RPI / c2t_safe) * (1.0 / _RPI - sX * wX)
    B3_small = (1.0 / c2t_safe) * (
        -1.0
        + 2.0 * _RPI * (1.0 - X - 2.0 * Y) * (1.0 / _RPI - sX * wX)
        + 2.0 * _RPI * sXY * wXY)
    X_safe = torch.where(torch.abs(X) < 1e-300, 1.0, X)
    inv_x = 1.0 / X_safe - 1.5 / (X_safe * X_safe)
    A3_big = (1.0 / c2t_safe) * inv_x
    B3_big = (1.0 / c2t_safe) * (-1.0 + (1.0 - X - 2.0 * Y) * inv_x
                                 + 2.0 * _RPI * sXY * wXY)
    small3 = torch.abs(sX) <= 4.0e3
    A3 = torch.where(small3, A3_small, A3_big)
    B3 = torch.where(small3, B3_small, B3_big)

    A = torch.where(part1, A1, torch.where(part2, A2,
                                           torch.where(part3, A3, A4)))
    B = torch.where(part1, B1, torch.where(part2, B2,
                                           torch.where(part3, B3, B4)))

    LS = (1.0 / math.pi) * A / (1.0 - (anuvc - eta * (c0 - 1.5 * c2)) * A
                                + eta * c2 * B)
    return LS.real, LS.imag


# hapi's PROFILE_* wrappers (misc/hapi.py:10034-10152)

def profile_ht(sg0, gamma_d, gamma0, gamma2, shift0, shift2, anuvc, eta, sg,
               device=None):
    """PROFILE_HT (misc/hapi.py:10034)."""
    return pcqsdhc(sg0, gamma_d, gamma0, gamma2, shift0, shift2, anuvc, eta,
                   sg, device)


def profile_sdvoigt(sg0, gamma_d, gamma0, gamma2, shift0, shift2, sg,
                    device=None):
    """PROFILE_SDVOIGT (misc/hapi.py:10117)."""
    return pcqsdhc(sg0, gamma_d, gamma0, gamma2, shift0, shift2, 0.0, 0.0, sg,
                   device)


def profile_sdrautian(sg0, gamma_d, gamma0, gamma2, shift0, shift2, anuvc,
                      sg, device=None):
    """PROFILE_SDRAUTIAN (misc/hapi.py:10089)."""
    return pcqsdhc(sg0, gamma_d, gamma0, gamma2, shift0, shift2, anuvc, 0.0,
                   sg, device)


def profile_rautian(sg0, gamma_d, gamma0, shift0, anuvc, sg, device=None):
    """PROFILE_RAUTIAN (misc/hapi.py:10104)."""
    return pcqsdhc(sg0, gamma_d, gamma0, 0.0, shift0, 0.0, anuvc, 0.0, sg,
                   device)
