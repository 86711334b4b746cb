"""Branchless Faddeeva function w(z) in real arithmetic (counterpart of
``radtxfr_tpu/kernels/faddeeva.py``).

hapi's ``hum1_wei`` (``misc/hapi.py:9833-9846``): the Humlicek region-1
asymptotic form everywhere, overwritten by a Weideman rational series where
|x| + y < 15. Both are evaluated and blended with ``torch.where``; valid for
y >= 0. Also hapi's other CPFs, compute-and-select as there: ``cpf3`` (the
15-term asymptotic series), ``cpf_humlicek`` (the 3-region Humlicek CPF)
and ``cef`` (the Weideman series alone, complex).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import arrays_on, as_tensor_on

__all__ = ["weideman_coeffs", "wofz_real", "WEIDEMAN_N", "REGION_BOUND",
           "cpf3", "cpf_humlicek", "cef", "wofz_real_series_only"]

WEIDEMAN_N = 24
#: |x| + y threshold between the Weideman series and the asymptotic form
#: (misc/hapi.py:9840)
REGION_BOUND = 15.0


@functools.lru_cache(maxsize=None)
def weideman_coeffs(n: int = WEIDEMAN_N):
    """(L, a[n]) — Weideman rational-series constants, float64.

    Reproduces ``cef`` (``misc/hapi.py:9812-9827``): sample
    f(t) = exp(-t^2)(L^2 + t^2) at t = L tan(theta/2), take the real FFT
    coefficients, keep a[1..n] reversed.
    """
    m = 2 * n
    m2 = 2 * m
    k = np.arange(-m + 1, m)
    L = np.sqrt(n / np.sqrt(2.0))
    theta = k * np.pi / m
    t = L * np.tan(theta / 2.0)
    f = np.zeros(t.size + 1)
    f[1:] = np.exp(-(t**2)) * (L**2 + t**2)
    a = np.real(np.fft.fft(np.fft.fftshift(f))) / m2
    a = a[1 : n + 1][::-1].copy()
    return float(L), a


def wofz_real(x: torch.Tensor, y: torch.Tensor, n: int = WEIDEMAN_N,
              device=None):
    """Faddeeva w(x + iy) -> (Re w, Im w), branchless, real arithmetic.
    NumPy arguments join a tensor argument's device, else ``device``
    (None: the card)."""
    x, y = arrays_on(x, y, device=device)
    L, a = weideman_coeffs(n)
    inv_sqrt_pi = 1.0 / np.sqrt(np.pi)

    # Humlicek region-1 asymptotic: w ~ (1/sqrt(pi)) t / (0.5 + t^2),
    # t = y - ix (misc/hapi.py:9834-9835)
    tr, ti = y, -x
    dr = 0.5 + y * y - x * x
    di = -2.0 * x * y
    dmag = dr * dr + di * di
    asym_r = inv_sqrt_pi * (tr * dr + ti * di) / dmag
    asym_i = inv_sqrt_pi * (ti * dr - tr * di) / dmag

    # Weideman series: Z = (L + iz)/(L - iz), z = x + iy
    nr, ni = L - y, x
    er, ei = L + y, -x
    emag = er * er + ei * ei
    zr = (nr * er + ni * ei) / emag
    zi = (ni * er - nr * ei) / emag
    pr = torch.full_like(zr, float(a[0]))
    pi_ = torch.zeros_like(zr)
    for c in a[1:]:
        pr, pi_ = pr * zr - pi_ * zi + float(c), pr * zi + pi_ * zr
    # w = 2p/(L - iz)^2 + (1/sqrt(pi))/(L - iz)
    sr = er * er - ei * ei
    si = 2.0 * er * ei
    smag = sr * sr + si * si
    wr = 2.0 * (pr * sr + pi_ * si) / smag + inv_sqrt_pi * er / emag
    wi = 2.0 * (pi_ * sr - pr * si) / smag - inv_sqrt_pi * ei / emag

    use_wei = (torch.abs(x) + y) < REGION_BOUND
    return torch.where(use_wei, wr, asym_r), torch.where(use_wei, wi, asym_i)


# --------------------------------------------------------------------------
# hapi's other two CPF implementations (misc/hapi.py:9645-9790), branchless
# --------------------------------------------------------------------------

#: the asymptotic series' 15 half-integer factors (misc/hapi.py:9642)
_TT = (0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5, 8.5, 9.5, 10.5, 11.5, 12.5,
       13.5, 14.5)
_INV_SQRT_PI = 0.564189583547756

#: Humlicek CPF nodes and weights (misc/hapi.py:9672-9674)
_HUM_T = (0.314240376, 0.947788391, 1.59768264, 2.27950708, 3.02063703,
          3.8897249)
_HUM_U = (1.01172805, -0.75197147, 1.2557727e-2, 1.00220082e-2,
          -2.42068135e-4, 5.00848061e-7)
_HUM_S = (1.393237, 0.231152406, -0.155351466, 6.21836624e-3, 9.19082986e-5,
          -6.27525958e-7)


def _asym_series(x, y, guard=0.0):
    """The 15-term large-|z| asymptotic CPF at z = x + iy -> (Re, Im);
    ``guard`` floors |z|^2 so that lanes of small |z| that are not selected
    give no inf or NaN."""
    zmag = torch.clamp(x * x + y * y, min=guard)
    # zm1 = 1/z = conj(z)/|z|^2, zm2 = zm1^2
    m1r, m1i = x / zmag, -y / zmag
    m2r = m1r * m1r - m1i * m1i
    m2i = 2.0 * m1r * m1i
    sr = torch.ones_like(m2r)
    si = torch.zeros_like(m2r)
    tr_, ti_ = torch.ones_like(m2r), torch.zeros_like(m2r)
    for tt_i in _TT:
        tr_, ti_ = ((tr_ * m2r - ti_ * m2i) * tt_i,
                    (tr_ * m2i + ti_ * m2r) * tt_i)
        sr, si = sr + tr_, si + ti_
    # zsum *= i zm1 / sqrt(pi)
    fr = (-m1i) * _INV_SQRT_PI
    fi = m1r * _INV_SQRT_PI
    return sr * fr - si * fi, sr * fi + si * fr


def _pair(x, y, device=None):
    x, y = arrays_on(x, y, device=device, lead=True)
    y = as_tensor_on(y, x.device)
    dt = torch.promote_types(torch.promote_types(x.dtype, y.dtype),
                             torch.float32)
    return torch.broadcast_tensors(x.to(dt), y.to(dt))


def cpf3(x, y, device=None):
    """hapi's 'naive' CPF (``cpf3``, ``misc/hapi.py:9645-9670``): the bare
    15-term asymptotic series, for large |z| only -> (Re w, Im w)."""
    return _asym_series(*_pair(x, y, device))


def cpf_humlicek(x, y, device=None):
    """The 3-region Humlicek CPF (hapi ``cpf``, ``misc/hapi.py:9677-9790``)
    -> (Re w, Im w), branchless: |z| > 8 the asymptotic series, else the
    6-term rational sums, region 2's where y <= 0.85 and
    |x| >= 18.1 y + 1.65. Region 1 uses the actual y where hapi reads it
    from X (``misc/hapi.py:9757``), as the JAX package does."""
    x, y = _pair(x, y, device)
    in3 = torch.sqrt(x * x + y * y) > 8.0
    in2 = (~in3) & (y <= 0.85) & (torch.abs(x) >= 18.1 * y + 1.65)

    wr3, wi3 = _asym_series(x, y, guard=1e-30)

    y1 = y + 1.5
    y2 = y1 * y1
    y3 = y + 3.0
    wr1 = torch.zeros_like(x)
    wi1 = torch.zeros_like(x)
    wr2 = torch.where(torch.abs(x) < 12.0,
                      torch.exp(-torch.clamp(x * x, max=144.0)), 0.0)
    wi2 = torch.zeros_like(x)
    for t_i, u_i, s_i in zip(_HUM_T, _HUM_U, _HUM_S):
        rm = x - t_i
        dm = 1.0 / (rm * rm + y2)
        d1m, d2m = y1 * dm, rm * dm
        rp = x + t_i
        dp = 1.0 / (rp * rp + y2)
        d1p, d2p = y1 * dp, rp * dp
        wr1 = wr1 + u_i * (d1m + d1p) - s_i * (d2m - d2p)
        wi1 = wi1 + u_i * (d2m + d2p) + s_i * (d1m - d1p)
        wr2 = wr2 + (y * (u_i * (rm * d2m - 1.5 * d1m) + s_i * y3 * d2m)
                     / (rm * rm + 2.25)
                     + y * (u_i * (rp * d2p - 1.5 * d1p) - s_i * y3 * d2p)
                     / (rp * rp + 2.25))
        wi2 = wi2 + u_i * (d2m + d2p) + s_i * (d1m - d1p)

    wr = torch.where(in3, wr3, torch.where(in2, wr2, wr1))
    wi = torch.where(in3, wi3, torch.where(in2, wi2, wi1))
    return wr, wi


def cef(x, y, n: int = WEIDEMAN_N, device=None):
    """The Weideman rational series w(z) with ``n`` terms (hapi ``cef``,
    ``misc/hapi.py:9812-9827``), complex (complex64 for float32 inputs,
    complex128 for float64); assumes Im z >= 0."""
    wr, wi = wofz_real_series_only(x, y, n, device)
    return torch.complex(wr, wi)


def wofz_real_series_only(x, y, n: int = WEIDEMAN_N, device=None):
    """The Weideman series leg of :func:`wofz_real` alone, with no
    asymptotic blend -> (Re, Im): ``cef`` in real arithmetic."""
    x, y = _pair(x, y, device)
    L, a = weideman_coeffs(n)
    inv_sqrt_pi = 1.0 / np.sqrt(np.pi)
    nr, ni = L - y, x
    er, ei = L + y, -x
    emag = er * er + ei * ei
    zr = (nr * er + ni * ei) / emag
    zi = (ni * er - nr * ei) / emag
    pr = torch.full_like(zr, float(a[0]))
    pi_ = torch.zeros_like(zr)
    for c in a[1:]:
        pr, pi_ = pr * zr - pi_ * zi + float(c), pr * zi + pi_ * zr
    sr = er * er - ei * ei
    si = 2.0 * er * ei
    smag = sr * sr + si * si
    wr = 2.0 * (pr * sr + pi_ * si) / smag + inv_sqrt_pi * er / emag
    wi = 2.0 * (pi_ * sr - pr * si) / smag - inv_sqrt_pi * ei / emag
    return wr, wi
