"""Branchless Faddeeva function w(z) in real arithmetic (counterpart of
``radtxfr_tpu/kernels/faddeeva.py``: ``weideman_coeffs``, ``REGION_BOUND``,
``wofz_real``).

hapi's ``hum1_wei`` (``misc/hapi.py:9833-9846``): the Humlicek region-1
asymptotic form everywhere, overwritten by a Weideman rational series where
|x| + y < 15. Both are evaluated and blended with ``torch.where``; valid for
y >= 0.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["weideman_coeffs", "wofz_real", "WEIDEMAN_N", "REGION_BOUND"]

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


def wofz_real(x: torch.Tensor, y: torch.Tensor, n: int = WEIDEMAN_N):
    """Faddeeva w(x + iy) -> (Re w, Im w), branchless, real arithmetic."""
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
