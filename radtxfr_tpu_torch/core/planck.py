"""Planck radiation physics (counterpart of ``radtxfr_tpu/core/planck.py``):
the Planck / brightness-temperature trio of the reference
(``radiative_transfer.py:792-1014``).

* :func:`planckian` — spectral radiance B(X, T), (N, *T.shape), spectral
  axis first;
* :func:`brightness_temperature` — its inverse in T;
* :func:`bt2l` — brightness temperature to radiance.

Units are explicit through ``wavelength=`` (no ``mean(X) < 50``
auto-detection): wavenumber mode X [cm^-1] -> L [µW/(cm^2 sr cm^-1)];
wavelength mode X [µm] -> L [µW/(cm^2 sr µm)]. Invalid radiances or
temperatures map to ``bad_value`` (NaN by default). Every function computes
in the promoted dtype of its inputs, on the device of whichever input is a
tensor, and on ``device`` (None: the card) when neither is.
"""

from __future__ import annotations

import torch

from .. import as_tensor_on
from .constants import C1, C2

__all__ = ["planckian", "brightness_temperature", "bt2l"]


def _tensors(X, Y, device=None):
    """``X`` flattened and ``Y`` as tensors on one device: the tensor
    input's, else ``device`` (None: the card;
    :func:`~radtxfr_tpu_torch.as_tensor_on`)."""
    dev = (Y.device if isinstance(Y, torch.Tensor)
           else X.device if isinstance(X, torch.Tensor) else device)
    return as_tensor_on(X, dev).reshape(-1), as_tensor_on(Y, dev)


def _radiance(Xb, T, wavelength: bool):
    """B at broadcastable X (spectral column) and T."""
    if wavelength:
        lam = Xb * 1e-6                                   # [m] from [µm]
        return C1 / (lam**5 * torch.expm1(C2 / (lam * T))) * 1e-4
    nu = Xb * 100.0                                       # [1/m] from [1/cm]
    return C1 * nu**3 / torch.expm1(C2 * nu / T) * 1e4


def planckian(X, T, wavelength: bool = False,
              device=None) -> torch.Tensor:
    """Planck radiance B(X, T) with shape (N, *T.shape), spectral axis first.

    ``X`` (N,) wavenumbers [cm^-1] (µm with ``wavelength=True``); ``T``
    temperatures [K] of any shape.
    """
    X, T = _tensors(X, T, device)
    L = _radiance(X[:, None], T.reshape(1, -1), wavelength)
    return L.reshape((X.numel(), *T.shape))


def brightness_temperature(X, L, wavelength: bool = False,
                           bad_value=float("nan"),
                           device=None) -> torch.Tensor:
    """Brightness temperature [K] of spectral radiance ``L`` (N, ...)
    (spectral axis first) on axis ``X`` (N,); radiances that are not
    finite or not positive give ``bad_value``
    (``radiative_transfer.py:851-933``)."""
    X, L = _tensors(X, L, device)
    Xb = X.reshape((-1,) + (1,) * (L.dim() - 1))
    if wavelength:
        lam = Xb * 1e-6
        T = C2 / (lam * torch.log1p(C1 / (lam**5 * (L * 1e4))))
    else:
        nu = Xb * 100.0
        T = C2 * nu / torch.log1p(C1 * nu**3 / (L * 1e-4))
    bad = ~torch.isfinite(L) | (L <= 0)
    return torch.where(bad, torch.full_like(T, bad_value), T)


def bt2l(X, T, wavelength: bool = False, bad_value=float("nan"),
         device=None) -> torch.Tensor:
    """Spectral radiance of brightness temperatures ``T`` (N, ...) on axis
    ``X`` (N,), the forward of :func:`brightness_temperature`;
    temperatures that are not finite or not positive give ``bad_value``
    (``radiative_transfer.py:936-1014``)."""
    X, T = _tensors(X, T, device)
    L = _radiance(X.reshape((-1,) + (1,) * (T.dim() - 1)), T, wavelength)
    bad = ~torch.isfinite(T) | (T <= 0)
    return torch.where(bad, torch.full_like(L, bad_value), L)
