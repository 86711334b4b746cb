"""Bucketed lines x wavenumbers line-shape accumulation (K1).

Counterpart of ``radtxfr_tpu/kernels/pallas_xsect.py`` for the production
OD path: the host planning (:class:`UniformGrid`, :class:`BucketPlan`,
:func:`auto_block`, :func:`plan_buckets_packed`, NumPy as in JAX) and the
layer-fused kernel ``_make_fused_kernel`` in its modes

* ``asym`` — the guarded Humlicek asymptotic Re w everywhere in the window
  (the cheap far-wing pass);
* ``core`` — (Weideman - guarded asym) inside hum1_wei's |x| + y < 15, zero
  outside, so asym + core equals the single-pass blend pointwise;
* ``mix`` — the unguarded K/L blend scaled by K + Y L (first-order
  Rosenkranz line mixing).

:func:`xsect_fused` launches the hand-written CUDA kernel
(``csrc/fused_xsect.cu``) for CUDA tensors and runs the plain PyTorch
version :func:`xsect_fused_plain` for CPU tensors; :data:`LAUNCHES` counts
kernel launches per mode. Both read the packed plan's per-slot line index
(:class:`DevicePlan`) and index the (nLay, L) parameter rows directly,
instead of materialising packed (n_blocks, nLay, block) copies.

Grid-index arithmetic (``pallas_xsect.py:16-20``): a point's distance from
a line centre is (k_grid - k_line) in int32, converted to float, minus the
float32 fraction ``frac0`` of the centre's grid position, so dnu carries
~1e-7 relative error; padding slots park at ``k_line = -2**30`` and never
pass the window mask.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from .. import _build
from .._build import check_tensor
from .faddeeva import REGION_BOUND, weideman_coeffs

__all__ = ["UniformGrid", "BucketPlan", "DevicePlan", "auto_block",
           "plan_buckets_packed", "device_plan", "xsect_fused",
           "xsect_fused_plain", "LAUNCHES", "MODES"]

MODES = ("asym", "core", "mix")
#: kernel launches per mode since the last reset (plain runs not counted)
LAUNCHES = {m: 0 for m in MODES}

_SQRT_LN2 = math.sqrt(math.log(2.0))
_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)
#: the asym form's denominator clamp (``pallas_xsect.py:378-397``)
_GUARD = 0.25
#: Weideman terms the CUDA kernel stages in shared memory at most
_MAX_WEIDEMAN = 32
#: (layer, slot, point) elements the plain version evaluates per step
_PLAIN_MAX_ELEMS = 1 << 23


@dataclasses.dataclass(frozen=True)
class UniformGrid:
    """A uniform wavenumber grid nu_k = x0 + k*dx, k = 0..n-1 (static)."""

    x0: float
    dx: float
    n: int

    @staticmethod
    def from_axis(X) -> "UniformGrid":
        # tolerance scales with the input dtype: a float32 axis at
        # nu ~ 1000 cm^-1 carries ~6e-5 cm^-1 of per-point rounding
        X = np.asarray(X)
        eps = np.finfo(X.dtype).eps if X.dtype.kind == "f" else 1e-16
        X = X.astype(np.float64)
        dx = float((X[-1] - X[0]) / (X.size - 1))
        tol = max(1e-6 * abs(dx), 4.0 * eps * np.abs(X).max())
        if np.abs(np.diff(X) - dx).max() > tol:
            raise ValueError("grid is not uniform")
        return UniformGrid(x0=float(X[0]), dx=dx, n=int(X.size))

    def values(self, dtype=np.float64) -> np.ndarray:
        return (self.x0 + self.dx * np.arange(self.n)).astype(dtype)


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    """Host-side static packed bucketing of sorted lines onto nu-tiles."""

    grid: UniformGrid
    tile: int            # nu points per tile
    block: int           # line slots per block
    n_tiles: int
    n_blocks: int
    max_blocks: int      # most blocks any tile visits
    starts: np.ndarray   # (n_tiles,) int32 — first block index per tile
    counts: np.ndarray   # (n_tiles,) int32 — number of blocks per tile
    k_line: np.ndarray   # (n_blocks, 1, block) int32 — floor grid index
    frac0: np.ndarray    # (n_blocks, 1, block) f32 — fractional grid offset
    max_wing: float      # cm^-1 — wing bound the bucketing guarantees
    gather: np.ndarray   # (n_blocks, block) int32 line index, -1 = padding
    wing_line: np.ndarray | None = None   # per-line wing bounds [cm^-1]


def auto_block(nu0, grid: UniformGrid, max_wing: float, tile: int,
               lo: int = 8, hi: int = 256) -> int:
    """Line-block size near the 75th-percentile per-tile line count."""
    nu0 = np.asarray(nu0, dtype=np.float64)
    n_tiles = -(-grid.n // tile)
    edges = grid.x0 + grid.dx * tile * np.arange(n_tiles + 1)
    lo_i = np.searchsorted(nu0, edges[:-1] - max_wing, side="left")
    hi_i = np.searchsorted(nu0, edges[1:] + max_wing, side="right")
    counts = hi_i - lo_i
    counts = counts[counts > 0]
    if counts.size == 0:
        return lo
    q = float(np.quantile(counts, 0.75))
    return int(np.clip(8 * int(np.ceil(q / 8.0)), lo, hi))


def plan_buckets_packed(nu0, grid: UniformGrid, max_wing, tile: int = 1024,
                        block="auto") -> BucketPlan:
    """Per-tile packed bucketing: each tile's line list is materialised
    exactly (lines duplicated across the tiles their wings touch) and packed
    contiguously into blocks (``pallas_xsect.py:195-307``).

    ``max_wing`` may be a scalar or a per-line array; with an array each
    line lands only in the tiles its own wing bound touches and the kernel
    clamps the runtime wing per line (``plan.wing_line``).
    """
    nu0 = np.asarray(nu0, dtype=np.float64)
    if nu0.size == 0:
        raise ValueError("empty line list")
    if np.any(np.diff(nu0) < 0):
        raise ValueError("line centers must be sorted")

    w = np.asarray(max_wing, dtype=np.float64)
    per_line = w.ndim > 0
    w = np.broadcast_to(w, nu0.shape)

    n_tiles = -(-grid.n // tile)
    span_pts = tile * grid.dx
    # widen by one grid step so float rounding can only add a tile
    lo_t = np.floor((nu0 - w - grid.dx - grid.x0) / span_pts).astype(np.int64)
    hi_t = np.floor((nu0 + w + grid.dx - grid.x0) / span_pts).astype(np.int64)
    # lines whose window cannot touch the grid get no tiles at all
    x_end = grid.x0 + grid.dx * (grid.n - 1)
    in_range = ((nu0 + w >= grid.x0 - grid.dx)
                & (nu0 - w <= x_end + grid.dx))
    lo_t = np.clip(lo_t, 0, n_tiles - 1)
    hi_t = np.clip(hi_t, 0, n_tiles - 1)

    span = np.where(in_range, hi_t - lo_t + 1, 0).astype(np.int64)
    tot = int(span.sum())
    line_ids = np.repeat(np.arange(nu0.size, dtype=np.int64), span)
    start = np.cumsum(span) - span
    offs = np.arange(tot, dtype=np.int64) - np.repeat(start, span)
    tiles = np.repeat(lo_t, span) + offs
    order = np.argsort(tiles, kind="stable")   # stable: keeps nu0 order
    tiles = tiles[order]
    line_ids = line_ids[order]
    cnt = np.bincount(tiles, minlength=n_tiles).astype(np.int64)

    if block == "auto":
        nz = cnt[cnt > 0]
        q = float(np.quantile(nz, 0.75)) if nz.size else 8.0
        block = int(np.clip(8 * int(np.ceil(q / 8.0)), 8, 256))

    bpt = -(-cnt // block)                      # blocks per tile (may be 0)
    starts = np.zeros(n_tiles, dtype=np.int32)
    starts[1:] = np.cumsum(bpt)[:-1].astype(np.int32)
    n_blocks = max(int(bpt.sum()), 1)

    # entry j of tile i goes to flat slot starts[i]*block + j
    gather = np.full(n_blocks * block, -1, dtype=np.int64)
    tile_first = np.cumsum(cnt) - cnt
    within = np.arange(tot, dtype=np.int64) - tile_first[tiles]
    slots = starts.astype(np.int64)[tiles] * block + within
    gather[slots] = line_ids
    gather = gather.reshape(n_blocks, block).astype(np.int32)

    u = (nu0 - grid.x0) / grid.dx
    k_all = np.floor(u).astype(np.int64)
    f_all = (u - k_all).astype(np.float32)
    valid = gather >= 0
    safe = np.where(valid, gather, 0)
    k_line = np.where(valid, k_all[safe], -(2 ** 30)).astype(np.int32)
    frac0 = np.where(valid, f_all[safe], 0.0).astype(np.float32)

    counts = bpt.astype(np.int32)
    return BucketPlan(
        grid=grid, tile=tile, block=block, n_tiles=n_tiles,
        n_blocks=n_blocks,
        max_blocks=max(int(counts.max()) if counts.size else 0, 1),
        starts=starts, counts=counts,
        k_line=k_line.reshape(n_blocks, 1, block),
        frac0=frac0.reshape(n_blocks, 1, block),
        max_wing=float(w.max()), gather=gather,
        wing_line=(w.astype(np.float64) if per_line else None),
    )


@dataclasses.dataclass(frozen=True)
class DevicePlan:
    """A packed plan on the device, its slots mapped to global line ids."""

    tile: int
    block: int
    n_tiles: int
    max_blocks: int
    dx: float
    n_out: int
    starts: torch.Tensor   # (n_tiles,) int32
    counts: torch.Tensor   # (n_tiles,) int32
    k_line: torch.Tensor   # (n_slots,) int32, -2**30 on padding slots
    frac0: torch.Tensor    # (n_slots,) float32 (float64 for float64 runs)
    line: torch.Tensor     # (n_slots,) int32 global line index, -1 padding
    wcap: torch.Tensor     # (n_slots,) float32 per-slot wing cap [cm^-1]


def device_plan(plan: BucketPlan, line_idx, nu0, device=None,
                dtype=torch.float32) -> DevicePlan:
    """Move ``plan`` to ``device``; ``line_idx`` maps the plan's line list
    (the call's lines) to rows of the full (nLay, L) parameter arrays, whose
    float64 host centres are ``nu0``.

    ``frac0`` is the plan's float32 fraction for float32 runs; a float64 run
    recomputes it from ``nu0`` in float64, so its line positions carry no
    float32 rounding (~3e-8 grid units) either.
    """
    line_idx = np.asarray(line_idx, dtype=np.int64)
    g = plan.gather.reshape(-1)
    valid = g >= 0
    safe = np.where(valid, g, 0)
    gl = np.where(valid, line_idx[safe], -1)
    cap = (np.full(safe.shape, plan.max_wing) if plan.wing_line is None
           else plan.wing_line[safe])
    frac0 = plan.frac0.reshape(-1)
    if dtype == torch.float64:
        u = (np.asarray(nu0, dtype=np.float64)[np.maximum(gl, 0)]
             - plan.grid.x0) / plan.grid.dx
        frac0 = np.where(valid, u - np.floor(u), 0.0)
    t = lambda a, dt: torch.as_tensor(np.ascontiguousarray(a), dtype=dt,
                                      device=device)
    return DevicePlan(
        tile=plan.tile, block=plan.block, n_tiles=plan.n_tiles,
        max_blocks=plan.max_blocks, dx=plan.grid.dx, n_out=plan.grid.n,
        starts=t(plan.starts, torch.int32), counts=t(plan.counts, torch.int32),
        k_line=t(plan.k_line.reshape(-1), torch.int32),
        frac0=t(frac0, dtype),
        line=t(gl, torch.int32),
        wcap=t(np.where(valid, cap.astype(np.float32), 0.0), torch.float32),
    )


# --------------------------------------------------------------------------
# the plain PyTorch version
# --------------------------------------------------------------------------

def _asym_re_w(x, y, guard=0.0):
    """Humlicek region-1 asymptotic Re w, (1/sqrt(pi)) Re[t/(0.5 + t^2)]
    with t = y - ix; ``guard`` clamps the denominator magnitude."""
    dr = 0.5 + y * y - x * x
    di = -2.0 * x * y
    dmag = dr * dr + di * di
    if guard:
        dmag = torch.clamp(dmag, min=guard)
    return _INV_SQRT_PI * (y * dr - x * di) * (1.0 / dmag)


def _weideman_w(x, y, a, L):
    """(Re w, Im w) of the Weideman rational series (|x| + y < 15)."""
    nr, ni = L - y, x
    er, ei = L + y, -x
    inv_e = 1.0 / (er * er + ei * ei)
    zr = (nr * er + ni * ei) * inv_e
    zi = (ni * er - nr * ei) * inv_e
    pr = torch.full_like(zr, float(a[0]))
    pi_ = torch.zeros_like(zr)
    for c in a[1:]:
        pr, pi_ = pr * zr - pi_ * zi + float(c), pr * zi + pi_ * zr
    sr = er * er - ei * ei
    si = 2.0 * er * ei
    inv_s = 1.0 / (sr * sr + si * si)
    K = 2.0 * (pr * sr + pi_ * si) * inv_s + _INV_SQRT_PI * er * inv_e
    Lw = 2.0 * (pi_ * sr - pr * si) * inv_s - _INV_SQRT_PI * ei * inv_e
    return K, Lw


def _mode_value(mode, x, y, ymix, a, L):
    """Re w (or K + Y L) of ``mode`` before the line scale."""
    if mode == "asym":
        return _asym_re_w(x, y, _GUARD)
    in_core = (torch.abs(x) + y) < REGION_BOUND
    Kw, Lw = _weideman_w(x, y, a, L)
    if mode == "core":
        return torch.where(in_core, Kw - _asym_re_w(x, y, _GUARD), 0.0)
    dr = 0.5 + y * y - x * x
    di = -2.0 * x * y
    inv = _INV_SQRT_PI * (1.0 / (dr * dr + di * di))
    Ka = (y * dr - x * di) * inv
    La = -(x * dr + y * di) * inv
    return (torch.where(in_core, Kw, Ka)
            + ymix * torch.where(in_core, Lw, La))


def _slot_constants(dplan, lay_idx, shift0, strength, gamma_d, gamma_0, wing,
                    ymix, mode):
    """(nl, n_slots) per-(layer, slot) line constants, padding slots filled
    as the Pallas wrapper pads them (strength 0, gamma 1, wing 0)."""
    lay = lay_idx.long()
    valid = dplan.line >= 0
    safe = torch.where(valid, dplan.line, 0).long()
    dt = strength.dtype

    def take(a, fill):
        return torch.where(valid, a[lay][:, safe],
                           torch.tensor(fill, dtype=dt, device=a.device))

    dx = dplan.dx
    gd = take(gamma_d, 1.0)
    cte = _SQRT_LN2 / gd
    return dict(
        ds=take(shift0 / dx, 0.0),
        xs=dx * cte,
        y=take(gamma_0, 1.0) * cte,
        scale=take(strength, 0.0) * (_INV_SQRT_PI * cte),
        wingu=torch.where(valid, torch.minimum(
            wing[lay][:, safe], dplan.wcap.to(dt)) / dx,
            torch.tensor(0.0, dtype=dt, device=wing.device)),
        ymix=take(ymix, 1.0) if mode == "mix" else None,
    )


def xsect_fused_plain(dplan: DevicePlan, lay_idx, shift0, strength, gamma_d,
                      gamma_0, wing, ymix=None, mode: str = "asym",
                      n_weideman: int = 16) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, in the parameters' dtype
    (float32 or float64) on their device.

    Parameters are (nLay, L) rows over the full line list; ``lay_idx``
    selects this call's layers. For each tile and each of its blocks it
    evaluates the dense (layers, block, tile) line shapes, masks them to
    hapi's window and sums over the block. Returns (len(lay_idx), n_out).
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    dt, dev = strength.dtype, strength.device
    c = _slot_constants(dplan, lay_idx, shift0, strength, gamma_d, gamma_0,
                        wing, ymix, mode)
    nl = c["xs"].shape[0]
    L_w, a_w = weideman_coeffs(n_weideman)
    tile, block = dplan.tile, dplan.block
    out = torch.zeros((nl, dplan.n_tiles, tile), dtype=dt, device=dev)
    kk = torch.arange(tile, dtype=torch.int32, device=dev)
    bb = torch.arange(block, dtype=torch.int64, device=dev)
    counts = dplan.counts.long()
    chunk = max(1, _PLAIN_MAX_ELEMS // (nl * block * tile))
    for j in range(dplan.max_blocks):
        tiles = torch.nonzero(counts > j).reshape(-1)
        for lo in range(0, tiles.numel(), chunk):
            t_i = tiles[lo:lo + chunk]
            slots = (dplan.starts.long()[t_i] + j)[:, None] * block + bb
            k_grid = (t_i.to(torch.int32)[:, None] * tile + kk)[:, None, :]
            rel = (k_grid - dplan.k_line[slots][:, :, None]).to(dt)
            u = (rel - dplan.frac0.to(dt)[slots][:, :, None])[None]
            s = {k: None if v is None else v[:, slots][..., None]
                 for k, v in c.items()}
            val = _mode_value(mode, (u - s["ds"]) * s["xs"], s["y"],
                              s["ymix"], a_w, L_w)
            mask = (u > -s["wingu"]) & (u <= s["wingu"])
            out[:, t_i] += torch.where(mask, s["scale"] * val, 0.0).sum(dim=2)
    return out.reshape(nl, -1)[:, :dplan.n_out]


# --------------------------------------------------------------------------
# the CUDA kernel's wrapper
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _weideman_table(n: int, device) -> torch.Tensor:
    """[L, a_0 .. a_{n-1}] as float32 on ``device`` (the kernel's table)."""
    L, a = weideman_coeffs(n)
    return torch.tensor([L, *a], dtype=torch.float32, device=device)


def xsect_fused(dplan: DevicePlan, lay_idx, shift0, strength, gamma_d,
                gamma_0, wing, ymix=None, mode: str = "asym",
                n_weideman: int = 16) -> torch.Tensor:
    """One fused line-shape pass: (len(lay_idx), n_out) float32.

    CPU tensors run :func:`xsect_fused_plain`. CUDA tensors launch the
    CUDA kernel on the current stream; anything it does not take (another
    dtype than float32, non-contiguous or mismatched shapes, mixed devices)
    raises, as does a non-zero CUDA error from the launch.
    """
    if mode not in MODES:
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode == "mix" and ymix is None:
        raise ValueError("mode 'mix' needs the mixing coefficients ymix")
    if strength.device.type == "cpu":
        return xsect_fused_plain(dplan, lay_idx, shift0, strength, gamma_d,
                                 gamma_0, wing, ymix, mode, n_weideman)
    if strength.device.type != "cuda":
        raise ValueError(f"unsupported device {strength.device}")
    dev = strength.device
    params = dict(shift0=shift0, strength=strength, gamma_d=gamma_d,
                  gamma_0=gamma_0, wing=wing)
    if mode == "mix":
        params["ymix"] = ymix
    if strength.dim() != 2:
        raise ValueError(f"strength must be (nLay, L), got "
                         f"{tuple(strength.shape)}")
    for name, t in params.items():
        check_tensor(name, t, torch.float32, dev, tuple(strength.shape))
    check_tensor("lay_idx", lay_idx, torch.int32, dev)
    for name in ("starts", "counts", "k_line", "line"):
        check_tensor(name, getattr(dplan, name), torch.int32, dev)
    for name in ("frac0", "wcap"):
        check_tensor(name, getattr(dplan, name), torch.float32, dev)
    n_slots = dplan.k_line.numel()
    if (dplan.starts.numel() != dplan.n_tiles
            or dplan.counts.numel() != dplan.n_tiles
            or n_slots % dplan.block
            or any(getattr(dplan, f).numel() != n_slots
                   for f in ("frac0", "line", "wcap"))):
        raise ValueError("inconsistent DevicePlan shapes")
    if dplan.n_tiles * dplan.tile < dplan.n_out:
        raise ValueError("the plan's tiles do not cover n_out points")
    if not 1 <= n_weideman <= _MAX_WEIDEMAN:
        raise ValueError(f"n_weideman must be in [1, {_MAX_WEIDEMAN}]")
    n_lay_call = lay_idx.numel()
    n_lines = strength.shape[1]
    out = torch.empty((n_lay_call, dplan.n_out), dtype=torch.float32,
                      device=dev)
    if n_lay_call == 0 or dplan.n_out == 0:
        return out
    wei = _weideman_table(n_weideman, dev)
    err = _build.library().radtxfr_fused_xsect(
        MODES.index(mode), dplan.starts.data_ptr(), dplan.counts.data_ptr(),
        dplan.k_line.data_ptr(), dplan.frac0.data_ptr(),
        dplan.line.data_ptr(), dplan.wcap.data_ptr(), lay_idx.data_ptr(),
        n_lay_call, shift0.data_ptr(), strength.data_ptr(),
        gamma_d.data_ptr(), gamma_0.data_ptr(), wing.data_ptr(),
        (ymix if mode == "mix" else strength).data_ptr(), n_lines,
        wei.data_ptr(), n_weideman, dplan.tile, dplan.block, dplan.n_tiles,
        dplan.n_out, dplan.dx, out.data_ptr(),
        torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_xsect kernel ({mode}) launch failed with "
                           f"CUDA error {err}")
    LAUNCHES[mode] += 1
    return out
