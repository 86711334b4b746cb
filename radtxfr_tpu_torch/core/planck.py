"""Planck spectral radiance (counterpart of ``radtxfr_tpu/core/planck.py``).

Wavenumber mode, X [cm^-1] -> L [µW/(cm^2 sr cm^-1)], the units of the
reference (``radiative_transfer.py:792-848``).
"""

from __future__ import annotations

import torch

from .constants import C1, C2

__all__ = ["planckian"]


def planckian(X: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """Planck radiance B(X, T) with shape (N, *T.shape), spectral axis first.

    ``X`` (N,) wavenumbers [cm^-1]; ``T`` temperatures [K] of any shape.
    Computes in the promoted dtype of the two inputs.
    """
    X = torch.as_tensor(X)
    T = torch.as_tensor(T)
    nu = X.reshape(-1, 1) * 100.0                 # [1/m] from [1/cm]
    L = C1 * nu**3 / torch.expm1(C2 * nu / T.reshape(1, -1))
    return (L * 1e4).reshape((X.numel(), *T.shape))
