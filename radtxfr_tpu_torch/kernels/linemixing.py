"""First-order Rosenkranz line mixing (counterpart of
``radtxfr_tpu/kernels/linemixing.py``).

Line k of a coupled branch acquires an asymmetric component

    k(nu) = S (cte/sqrt(pi)) [Re w(z) + Y Im w(z)],
    Y(p, T) = p [(1 - x_self) y_air + x_self y_self] (Tref/T)^n_T.

The fused kernel's ``mix`` mode (:mod:`.fused_xsect`) evaluates the same
expression; :func:`xsect_voigt_mixing` is its reference engine.
"""

from __future__ import annotations

import torch

from .. import arrays_on
from ..core.constants import SQRT_LN2, T_REF
from .faddeeva import wofz_real
from .lineparams import LineParams
from .xsect import live_chunks

__all__ = ["mixing_coefficient", "xsect_voigt_mixing"]

_INV_SQRT_PI = 0.5641895835477563


def mixing_coefficient(y_air, p_atm, T, y_self=None, x_self=0.0,
                       n_T: float = 0.0, device=None):
    """Per-line first-order mixing coefficient Y(p, T); ``y_self``
    defaults to ``y_air``. NumPy arguments join a tensor argument's
    device, else ``device`` (None: the card)."""
    y_air, p_atm, T, y_self, x_self = arrays_on(y_air, p_atm, T, y_self,
                                                x_self, device=device)
    y_s = y_air if y_self is None else y_self
    y_mix = (1.0 - x_self) * y_air + x_self * y_s
    return p_atm * y_mix * (T_REF / T) ** n_T


def xsect_voigt_mixing(grid: torch.Tensor, params: LineParams,
                       Y: torch.Tensor, chunk: int = 512,
                       n_weideman: int = 24) -> torch.Tensor:
    """Voigt spectrum with first-order mixing; same contract as
    :func:`.xsect.xsect_from_params` plus the per-line asymmetry ``Y``
    (blocks of lines whose windows miss the grid skipped, as there); a
    NumPy ``grid`` joins ``params``' device."""
    grid, = arrays_on(grid, device=params.nu0.device)
    acc = torch.zeros_like(grid)
    g = grid[None, :]
    Y = torch.broadcast_to(torch.as_tensor(Y, dtype=grid.dtype,
                                           device=grid.device),
                           params.nu0.shape)
    for lo in live_chunks(grid, params.nu0, params.wing, chunk):
        p = {k: v[lo:lo + chunk, None] for k, v in vars(params).items()}
        cte = SQRT_LN2 / p["gamma_d"]
        K, L = wofz_real((g - p["nu0_shifted"]) * cte, p["gamma_0"] * cte,
                         n_weideman)
        vals = _INV_SQRT_PI * cte * (K + Y[lo:lo + chunk, None] * L)
        mask = (g > p["nu0"] - p["wing"]) & (g <= p["nu0"] + p["wing"])
        acc = acc + torch.where(mask, p["strength"] * vals, 0.0).sum(dim=0)
    return acc
