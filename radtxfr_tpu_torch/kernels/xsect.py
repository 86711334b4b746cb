"""Line-by-line spectrum synthesis, the reference engine (counterpart of
``radtxfr_tpu/kernels/xsect.py``).

Lines are processed in fixed chunks; each chunk evaluates a dense
(chunk, N) profile block with hapi's wing-window mask: a grid point g
contributes iff nu0 - wing < g <= nu0 + wing (window on the *unshifted*
centre, profile on the shifted one, ``misc/hapi.py:11133-11135``). This is
the contract the fused kernels (:mod:`.fused_xsect`) are held to.
"""

from __future__ import annotations

import torch

from .lineparams import LineParams
from .profiles import doppler, lorentz, voigt

__all__ = ["xsect_from_params"]


def xsect_from_params(grid: torch.Tensor, params: LineParams,
                      profile: str = "voigt", chunk: int = 512, *,
                      n_weideman: int = 24) -> torch.Tensor:
    """(N,) spectrum: sum over lines of strength * profile(grid), masked to
    each line's wing window. ``params`` holds (L,) tensors; ``profile`` is
    'voigt' (``n_weideman`` Weideman terms), 'lorentz' or 'doppler'.
    'sdvoigt' needs the complex pcqsdhc of the JAX package's ``htp.py``,
    which is not ported (ROADMAP M13)."""
    if profile == "sdvoigt":
        raise NotImplementedError(
            "profile 'sdvoigt' in the reference engine needs the complex "
            "pcqsdhc of kernels/htp.py, not ported yet (ROADMAP M13); the "
            "fused builders (make_od_fn, make_xsect_fn) evaluate SD-Voigt")
    if profile not in ("voigt", "lorentz", "doppler"):
        raise ValueError(profile)
    acc = torch.zeros_like(grid)
    g = grid[None, :]
    for lo in range(0, params.nu0.shape[0], chunk):
        p = {k: v[lo:lo + chunk, None] for k, v in vars(params).items()}
        dnu = g - p["nu0_shifted"]
        if profile == "voigt":
            vals = voigt(dnu, p["gamma_d"], p["gamma_0"], n_weideman)
        elif profile == "lorentz":
            vals = lorentz(dnu, p["gamma_0"])
        else:
            vals = doppler(dnu, p["gamma_d"])
        mask = (g > p["nu0"] - p["wing"]) & (g <= p["nu0"] + p["wing"])
        acc = acc + torch.where(mask, p["strength"] * vals, 0.0).sum(dim=0)
    return acc
