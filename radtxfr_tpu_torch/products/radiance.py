"""At-sensor apparent radiance forward model (counterpart of
``radtxfr_tpu/products/radiance.py``).

    L = tau * [ eps * B(Ts + dT) + (1 - eps) * Ld ] + Lu

One broadcast over (nX, nE materials, nA atmospheres[, nT temperature
deltas]), as the reference's ``compute_LWIR_apparent_radiance``
(``radiative_transfer.py:1017-1069``), in plain PyTorch on one device.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import as_tensor_on, resolve_device
from ..core.planck import planckian

__all__ = ["apparent_radiance"]


def apparent_radiance(X, emis, Ts, tau, Lu, Ld, dT=None,
                      return_Ls: bool = False, device=None, dtype=None):
    """Apparent spectral radiance for every (material, atmosphere[, dT]).

    ``X`` (nX,) wavenumbers [cm^-1]; ``emis`` (nX, nE) emissivities;
    ``Ts`` (nA,) surface temperatures [K]; ``tau``, ``Lu``, ``Ld`` (nX, nA)
    transmittance, upwelling and downwelling radiance per atmosphere;
    ``dT`` optional (nT,) surface-temperature deltas [K]. Arrays or
    tensors; they are computed on ``device`` in ``dtype`` (None: the
    device of the first tensor among ``tau``, ``X``, ``emis``, ``Ts``,
    ``Lu``, ``Ld``, else the card; ``tau``'s dtype where it is a tensor or
    a NumPy float array, else float64).

    Returns L (nX, nE, nA) or (nX, nE, nA, nT) [µW/(cm^2 sr cm^-1)]
    (with ``return_Ls``, also the surface-leaving radiance).
    """
    if device is None:
        device = next((a.device for a in (tau, X, emis, Ts, Lu, Ld)
                       if isinstance(a, torch.Tensor)), None)
    if isinstance(tau, torch.Tensor):
        dtype = tau.dtype if dtype is None else dtype
    elif isinstance(tau, np.ndarray) and tau.dtype.kind == "f" \
            and dtype is None:
        dtype = as_tensor_on(tau.ravel()[:0], "cpu").dtype
    device = resolve_device(device)
    dtype = torch.float64 if dtype is None else dtype
    t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    X, emis, tau, Lu, Ld = map(t, (X, emis, tau, Lu, Ld))
    Ts = t(Ts).reshape(-1)
    if dT is not None:
        T_ = Ts[:, None] + t(dT).reshape(-1)[None, :]      # (nA, nT)
        B_ = planckian(X, T_)[:, None, :, :]               # (nX, 1, nA, nT)
        tau_, Lu_, Ld_ = (a[:, None, :, None] for a in (tau, Lu, Ld))
        em_ = emis[:, :, None, None]
    else:
        B_ = planckian(X, Ts)[:, None, :]                  # (nX, 1, nA)
        tau_, Lu_, Ld_ = (a[:, None, :] for a in (tau, Lu, Ld))
        em_ = emis[:, :, None]
    Ls = em_ * B_ + (1.0 - em_) * Ld_
    L = tau_ * Ls + Lu_
    return (L, Ls) if return_Ls else L
