"""Planck-fit utilities (counterpart of ``radtxfr_tpu/scene/planck_fit.py``):
the working equivalent of the reference's ``misc/PlayingWithPlanck.py``
(checked in broken at ``:29``), a least-squares fit of
L(nu) ~ eps B(nu, T) with the scale (the graybody emissivity) solved in
closed form per candidate temperature and a scan-and-refine over T.
"""

from __future__ import annotations

import torch

from .. import arrays_on, as_tensor_on
from ..core.planck import planckian

__all__ = ["fit_planck"]


def fit_planck(X, L, t_min: float = 150.0, t_max: float = 400.0,
               n_coarse: int = 128, n_refine: int = 3, device=None):
    """Fit eps B(nu, T) to a spectrum ``L`` (nX,) on axis ``X``; returns
    (T, eps, residual) as 0-d tensors. A grid search over T with the
    optimal scale per candidate (eps = <L, B>/<B, B>), then ``n_refine``
    bracket refinements of 32 points. NumPy arguments join a tensor
    argument's device, else ``device`` (None: the card)."""
    L, X = arrays_on(L, X, device=device, lead=True)
    X = as_tensor_on(X, L.device, L.dtype)

    def scan_range(lo, hi, n):
        Ts = lo + (hi - lo) * torch.linspace(0.0, 1.0, n, dtype=L.dtype,
                                             device=L.device)
        B = planckian(X, Ts)                    # (nX, n)
        eps = torch.sum(B * L[:, None], dim=0) / torch.sum(B * B, dim=0)
        resid = torch.sum((L[:, None] - eps[None, :] * B) ** 2, dim=0)
        i = torch.argmin(resid)
        return Ts[i], eps[i], resid[i], (hi - lo) / (n - 1)

    t, e, r, step = scan_range(t_min, t_max, n_coarse)
    for _ in range(n_refine):
        t, e, r, step = scan_range(t - step, t + step, 32)
    return t, e, r
