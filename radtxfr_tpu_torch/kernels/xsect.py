"""Line-by-line spectrum synthesis, the reference engine (counterpart of
``radtxfr_tpu/kernels/xsect.py``).

Lines are processed in fixed chunks; each chunk evaluates a dense
(chunk, N) profile block with hapi's wing-window mask: a grid point g
contributes iff nu0 - wing < g <= nu0 + wing (window on the *unshifted*
centre, profile on the shifted one, ``misc/hapi.py:11133-11135``). This is
the contract the fused kernels (:mod:`.fused_xsect`) are held to.
SD-Voigt is the complex pcqsdhc of :mod:`.htp` at the unshifted centre,
the shift carried inside the profile.
"""

from __future__ import annotations

import torch

from .. import arrays_on
from .htp import profile_sdvoigt
from .lineparams import LineParams
from .profiles import doppler, lorentz, voigt

__all__ = ["xsect_from_params", "pad_params", "live_chunks"]


def live_chunks(grid: torch.Tensor, nu0, wing, chunk: int) -> list:
    """The starts of the ``chunk``-line blocks of which some line's window
    nu0 - wing < g <= nu0 + wing can hold a point of the increasing
    ``grid``, the same expressions as the mask. Every other block's masked
    contribution is exactly zero, so skipping it changes no value; one
    host transfer a call."""
    nu0 = torch.broadcast_to(torch.as_tensor(nu0, device=grid.device),
                             wing.shape)
    live = (nu0 - wing < grid[-1]) & (nu0 + wing >= grid[0])
    n = live.shape[-1]
    pad = torch.zeros(live.shape[:-1] + ((-n) % chunk,), dtype=torch.bool,
                      device=live.device)
    blocks = torch.cat([live, pad], dim=-1).reshape(-1, chunk).any(dim=1)
    return [int(b) * chunk for b in torch.nonzero(blocks).flatten().tolist()]


def pad_params(params: LineParams, multiple: int) -> LineParams:
    """``params`` with inert lines appended up to a multiple of
    ``multiple`` lines (zero strength and wing, centres at -1e9)."""
    n = params.nu0.shape[-1]
    n_pad = (-n) % multiple
    if n_pad == 0:
        return params
    fill = dict(nu0=-1e9, nu0_shifted=-1e9, strength=0.0, gamma_d=1.0,
                gamma_0=1.0, wing=0.0, gamma_2=0.0, shift0=0.0)
    return LineParams(**{
        k: torch.cat([a, torch.full(a.shape[:-1] + (n_pad,), fill[k],
                                    dtype=a.dtype, device=a.device)], dim=-1)
        for k, a in vars(params).items()})


def xsect_from_params(grid: torch.Tensor, params: LineParams,
                      profile: str = "voigt", chunk: int = 512, *,
                      n_weideman: int = 24) -> torch.Tensor:
    """(N,) spectrum: sum over lines of strength * profile(grid), masked to
    each line's wing window. ``params`` holds (L,) tensors; ``profile`` is
    'voigt' (``n_weideman`` Weideman terms), 'lorentz', 'doppler' or
    'sdvoigt' (pcqsdhc with the speed dependence ``gamma_2``, whose
    parameters :func:`~.lineparams.compute_line_params` gives with
    ``profile='sdvoigt'``). A NumPy ``grid`` joins ``params``' device in
    its own dtype."""
    grid, = arrays_on(grid, device=params.nu0.device)
    if profile not in ("voigt", "lorentz", "doppler", "sdvoigt"):
        raise ValueError(profile)
    acc = torch.zeros_like(grid)
    g = grid[None, :]
    for lo in live_chunks(grid, params.nu0, params.wing, chunk):
        p = {k: v[lo:lo + chunk, None] for k, v in vars(params).items()}
        dnu = g - p["nu0_shifted"]
        if profile == "voigt":
            vals = voigt(dnu, p["gamma_d"], p["gamma_0"], n_weideman)
        elif profile == "lorentz":
            vals = lorentz(dnu, p["gamma_0"])
        elif profile == "sdvoigt":
            vals = profile_sdvoigt(0.0, p["gamma_d"], p["gamma_0"],
                                   p["gamma_2"], p["shift0"], 0.0, dnu)[0]
        else:
            vals = doppler(dnu, p["gamma_d"])
        mask = (g > p["nu0"] - p["wing"]) & (g <= p["nu0"] + p["wing"])
        acc = acc + torch.where(mask, p["strength"] * vals, 0.0).sum(dim=0)
    return acc
