"""Bucketed lines x wavenumbers line-shape accumulation (K1, K7) and its
forward-mode derivative (K3).

Counterpart of ``radtxfr_tpu/kernels/pallas_xsect.py`` for the OD and
cross-section paths: the host planning (:class:`UniformGrid`,
:class:`BucketPlan`, :func:`auto_block`, :func:`plan_buckets`,
:func:`plan_buckets_packed`, NumPy as in JAX), the layer-fused kernel
``_make_fused_kernel`` in every mode

* ``asym`` — the guarded Humlicek asymptotic Re w everywhere in the window
  (the cheap far-wing pass);
* ``core`` — (Weideman - guarded asym) inside hum1_wei's |x| + y < 15, zero
  outside, so asym + core equals the single-pass blend pointwise;
* ``mix`` — the unguarded K/L blend scaled by K + Y L (first-order
  Rosenkranz line mixing);
* ``full`` — the single-pass blend (Weideman inside |x| + y < 15, the
  unguarded asymptotic form outside): the differentiable path's primal;
* ``sdvoigt``, ``sdvoigt_asym``, ``sdvoigt_core`` — hapi's pcqsdhc with
  Gamma2 real (the SD-Voigt driver), its double-asymptotic far-wing form and
  their difference (``pallas_xsect.py:562-633``): the shift rides inside the
  profile (``shift0``) and the grid shift is zero;
* ``lorentz``, ``doppler`` — hapi's simple forms with its truncated
  constants (``pallas_xsect.py:52-60``);
* ``corr:R:{voigt,voigtfull,sdvoigt,sdvoigtfull}`` — the coarse-far
  correction: the point term minus the 4-point Lagrange-cubic interpolation
  of the guarded asymptotic far field through the coarse nodes (every R-th
  grid point, node row 0 one coarse step left of the tile), masked by the
  true window (no wing cap; ``pallas_xsect.py:762-879``);

the unfused kernel ``_make_kernel`` (K7: :func:`xsect_unfused`, plain
version :func:`xsect_unfused_plain`; the prebuilt-plan route of
``compute_od_layers``, one CTA per (layer, 256-point slice), K1's per-point
code in modes ``full``, ``asym``, ``core``, ``lorentz`` and ``doppler``)
and the tangent kernel ``_make_fused_jvp_kernel`` (K3), the directional
derivative of the ``full`` pass w.r.t. (shift0, strength, gamma_d, gamma_0)
from the region-consistent analytic derivatives of each approximation
(``pallas_xsect.py:469-559``), for a batch of tangent directions at once.

:func:`xsect_fused` and :func:`xsect_fused_jvp` launch the hand-written
CUDA kernels (``csrc/fused_xsect.cu``, ``csrc/fused_xsect_jvp.cu``) for
CUDA tensors and run the plain PyTorch versions :func:`xsect_fused_plain`
and :func:`xsect_fused_jvp_plain` for CPU tensors; :data:`LAUNCHES` counts
kernel launches per mode string (and ``"jvp"``). All read the packed plan's
per-slot line index (:class:`DevicePlan`) and index the (nLay, L) parameter
rows directly, instead of materialising packed (n_blocks, nLay, block)
copies.

:func:`xsect_fused_diff` is the differentiable ``full`` pass, the
counterpart of ``xsect_fused_voigt_diff`` (a ``jax.custom_jvp``): a
:class:`torch.autograd.Function` in the ``setup_context`` form, for
``torch.func.jvp`` (and ``torch.func.vmap`` over it, as ``jacfwd`` does);
its primal is K1 ``full`` and its ``jvp`` is K3, whose ``vmap`` rule turns
a batch of tangent directions into K3's direction axis. The tensors the
``jvp`` needs are kept with ``ctx.save_for_forward``, so dual tensors
(``torch.autograd.forward_ad``) work as well. Wing-cutoff tangents are
dropped: the window mask is piecewise constant, as in the reference's
finite differences.

:func:`xsect_fused_sdvoigt_diff` is the single-pass ``sdvoigt`` pass built
the same way (``xsect_fused_sdvoigt_diff`` there): K1 ``sdvoigt`` as the
primal, the SD-Voigt tangent kernel K4 (:func:`xsect_sdvoigt_jvp`,
``_make_fused_sdvoigt_jvp_kernel`` there, plain version
:func:`xsect_sdvoigt_jvp_plain`) as its ``jvp``, launches counted under
``"sdvoigt_jvp"``.

Grid-index arithmetic (``pallas_xsect.py:16-20``): a point's distance from
a line centre is (k_grid - k_line) in int32, converted to float, minus the
float32 fraction ``frac0`` of the centre's grid position, so dnu carries
~1e-7 relative error; padding slots park at ``k_line = -2**30`` and never
pass the window mask.

Spectral shards: a plan's tiles may carry global grid offsets
(``DevicePlan.tile_off``, the kernels' ``off_ref``): tile i's point k lies
at grid index i*tile + k + tile_off[i], which every window and node test
uses, and is written at the local index i*tile + k. :func:`shard_plan`
applies ``xsect_pallas``'s shard-local overrides (``starts``, ``counts``,
``k_line``, ``frac0``, ``k_offset``, ``n_tiles``, ``n_out``), which K1's,
K3's and K4's entry points, plain versions and differentiable passes also
take as keywords; :data:`OFFSET_LAUNCHES` counts the launches with offsets.
"""

from __future__ import annotations

import collections
import dataclasses
import functools
import math

import numpy as np
import torch

from .. import _build, as_numpy, resolve_device
from .._build import check_tensor
from ..core.constants import LN2, SQRT_LN2_DIV_SQRT_PI
from .faddeeva import REGION_BOUND, weideman_coeffs

__all__ = ["UniformGrid", "BucketPlan", "DevicePlan", "auto_block",
           "plan_buckets", "plan_buckets_packed", "device_plan", "xsect_fused",
           "xsect_fused_plain", "xsect_fused_jvp", "xsect_fused_jvp_plain",
           "xsect_fused_diff", "xsect_sdvoigt_jvp", "xsect_sdvoigt_jvp_plain",
           "xsect_fused_sdvoigt_diff", "xsect_unfused", "xsect_unfused_plain",
           "cubic_weights", "corr_r_supported", "shard_plan", "LAUNCHES",
           "OFFSET_LAUNCHES", "MODES",
           "UNFUSED_MODES", "CORR_VARIANTS", "SD_MODES"]

#: K1's modes other than the correction passes, in the CUDA switch's order
MODES = ("asym", "core", "mix", "full", "sdvoigt", "sdvoigt_asym",
         "sdvoigt_core", "lorentz", "doppler")
#: point-term variants of the correction modes ``corr:R:<variant>``
CORR_VARIANTS = ("voigt", "voigtfull", "sdvoigt", "sdvoigtfull")
#: the modes whose profile carries the shift and needs Gamma2
SD_MODES = ("sdvoigt", "sdvoigt_asym", "sdvoigt_core")
#: kernel launches since the last reset, per K1 mode string, of K7
#: ("unfused_<mode>"), K3 ("jvp"), K4 ("sdvoigt_jvp"), and of K5 and K6
#: ("ht", "ht_jvp", counted by :mod:`.fused_ht`); plain runs are not counted
LAUNCHES = collections.Counter()
#: the launches of :data:`LAUNCHES` whose plan carried tile offsets
#: (``DevicePlan.tile_off``: a spectrum shard's tiles), under the same keys
OFFSET_LAUNCHES = collections.Counter()

_SQRT_LN2 = math.sqrt(math.log(2.0))
_INV_SQRT_PI = 1.0 / math.sqrt(math.pi)
_INV_PI = 1.0 / math.pi
#: the asym form's denominator clamp (``pallas_xsect.py:378-397``)
_GUARD = 0.25
#: Weideman terms the CUDA kernel stages in shared memory at most
_MAX_WEIDEMAN = 32
#: (layer, slot, point) elements the plain version evaluates per step
_PLAIN_MAX_ELEMS = 1 << 23
#: tangent directions one K3 launch carries at most (csrc: ND_MAX)
_JVP_MAX_DIRS = 8
#: points of a CUDA CTA's slice of a tile (csrc: SPAN); a correction pass's
#: R must divide it, and be at least _CORR_MIN_R (csrc: NODES_MAX)
_SPAN = 256
_CORR_MIN_R = 8


def parse_mode(mode: str):
    """``(family, R, variant)`` of a K1 mode string: ``(mode, 0, None)``
    for the modes of :data:`MODES`, ``("corr", R, variant)`` for
    ``corr:R:variant``; raises on anything else."""
    if mode in MODES:
        return mode, 0, None
    parts = mode.split(":")
    if (len(parts) == 3 and parts[0] == "corr" and parts[1].isdigit()
            and int(parts[1]) > 0 and parts[2] in CORR_VARIANTS):
        return "corr", int(parts[1]), parts[2]
    raise ValueError(f"mode must be one of {MODES} or corr:R:<variant> with "
                     f"variant in {CORR_VARIANTS}, got {mode!r}")


def corr_r_supported(R) -> bool:
    """Whether the CUDA correction pass takes ``corr:R:*``: R divides its
    256-point slice (a slice starts on a coarse node) and is at least 8
    (which bounds its shared node buffer)."""
    return int(R) >= _CORR_MIN_R and _SPAN % int(R) == 0


def is_sd_mode(mode: str) -> bool:
    """Whether ``mode`` evaluates SD-Voigt (zero grid shift, the shift
    inside the profile, Gamma2 needed)."""
    fam, _, variant = parse_mode(mode)
    return fam in SD_MODES or (fam == "corr" and variant.startswith("sd"))


@dataclasses.dataclass(frozen=True)
class UniformGrid:
    """A uniform wavenumber grid nu_k = x0 + k*dx, k = 0..n-1 (static)."""

    x0: float
    dx: float
    n: int

    @staticmethod
    def from_axis(X) -> "UniformGrid":
        # tolerance scales with the input dtype: a float32 axis at
        # nu ~ 1000 cm^-1 carries ~6e-5 cm^-1 of per-point rounding;
        # a tensor is copied off its device
        X = as_numpy(X)
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
    """Host-side static bucketing of sorted lines onto nu-tiles: shared
    blocks (:func:`plan_buckets`) or packed per tile
    (:func:`plan_buckets_packed`)."""

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
    # packed plans: (n_blocks, block) int32 line index, -1 = padding;
    # None for shared-block plans (plan_buckets: slot s holds line s)
    gather: np.ndarray | None = None
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


def plan_buckets(nu0, grid: UniformGrid, max_wing: float, tile: int = 1024,
                 block="auto") -> BucketPlan:
    """Shared-block bucketing (``pallas_xsect.py:134-192``): the sorted
    lines in blocks of ``block`` (``'auto'``: :func:`auto_block`), each tile
    visiting the block range that holds every line within ``max_wing`` of
    it. ``max_wing`` must bound every runtime wing: the kernel clamps
    wings to it. Padding slots park at ``k_line = -2**30``."""
    nu0 = np.asarray(nu0, dtype=np.float64)
    if nu0.size == 0:
        raise ValueError("empty line list")
    if np.any(np.diff(nu0) < 0):
        raise ValueError("line centers must be sorted")
    if block == "auto":
        block = auto_block(nu0, grid, max_wing, tile)

    n_tiles = -(-grid.n // tile)
    n_lines_pad = -(-nu0.size // block) * block
    n_blocks = n_lines_pad // block

    # grid-index decomposition of each line centre (float64 -> int + frac)
    u = (nu0 - grid.x0) / grid.dx
    k_line = np.floor(u).astype(np.int64)
    frac0 = (u - k_line).astype(np.float32)
    k_line = k_line.astype(np.int32)

    # tile i covers [x0 + i tile dx, x0 + (i + 1) tile dx); a line can touch
    # it if its centre lies within max_wing of that interval
    edges = grid.x0 + grid.dx * tile * np.arange(n_tiles + 1)
    lo = np.searchsorted(nu0, edges[:-1] - max_wing, side="left")
    hi = np.searchsorted(nu0, edges[1:] + max_wing, side="right")
    b0 = (lo // block).astype(np.int32)
    b1 = np.ceil(hi / block).astype(np.int32)
    counts = np.maximum(b1 - b0, 0).astype(np.int32)
    max_blocks = max(int(counts.max()) if counts.size else 0, 1)

    pad = n_lines_pad - nu0.size
    k_pad = np.full(pad, np.int32(-(2**30)), dtype=np.int32)
    f_pad = np.zeros(pad, dtype=np.float32)
    return BucketPlan(
        grid=grid, tile=tile, block=block, n_tiles=n_tiles,
        n_blocks=n_blocks, max_blocks=max_blocks, starts=b0, counts=counts,
        k_line=np.concatenate([k_line, k_pad]).reshape(n_blocks, 1, block),
        frac0=np.concatenate([frac0, f_pad]).reshape(n_blocks, 1, block),
        max_wing=float(max_wing),
    )


def plan_buckets_packed(nu0, grid: UniformGrid, max_wing, tile: int = 1024,
                        block="auto", place_center=None) -> BucketPlan:
    """Per-tile packed bucketing: each tile's line list is materialised
    exactly (lines duplicated across the tiles their wings touch) and packed
    contiguously into blocks (``pallas_xsect.py:195-307``).

    ``max_wing`` may be a scalar or a per-line array; with an array each
    line lands only in the tiles its own wing bound touches and the kernel
    clamps the runtime wing per line (``plan.wing_line``). ``place_center``
    (default: the line centres) centres the placement intervals elsewhere,
    as the coarse-far correction passes place their window-edge bands at
    nu0 +- wing; ``k_line`` and ``frac0`` always come from ``nu0``.
    """
    nu0 = np.asarray(nu0, dtype=np.float64)
    if nu0.size == 0:
        raise ValueError("empty line list")
    if np.any(np.diff(nu0) < 0):
        raise ValueError("line centers must be sorted")

    w = np.asarray(max_wing, dtype=np.float64)
    per_line = w.ndim > 0
    w = np.broadcast_to(w, nu0.shape)
    pc = (nu0 if place_center is None
          else np.broadcast_to(np.asarray(place_center, dtype=np.float64),
                               nu0.shape))

    n_tiles = -(-grid.n // tile)
    span_pts = tile * grid.dx
    # widen by one grid step so float rounding can only add a tile
    lo_t = np.floor((pc - w - grid.dx - grid.x0) / span_pts).astype(np.int64)
    hi_t = np.floor((pc + w + grid.dx - grid.x0) / span_pts).astype(np.int64)
    # lines whose window cannot touch the grid get no tiles at all
    x_end = grid.x0 + grid.dx * (grid.n - 1)
    in_range = ((pc + w >= grid.x0 - grid.dx)
                & (pc - w <= x_end + grid.dx))
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
    #: (n_tiles,) int32 global grid offset of each tile (a tile's point k
    #: lies at grid index i*tile + k + tile_off[i]; the output at the local
    #: index i*tile + k); None is zero (``pallas_xsect.py``'s ``off_ref``)
    tile_off: torch.Tensor | None = None


def _offsets(k_offset, n_tiles: int, device):
    """``k_offset`` (a scalar or one int per tile) as the (n_tiles,) int32
    tile offsets on ``device``; None for a Python zero (the kernels' zero
    offset, no tensor)."""
    if isinstance(k_offset, (int, np.integer)):
        if k_offset == 0:
            return None
        return torch.full((n_tiles,), int(k_offset), dtype=torch.int32,
                          device=device)
    t = torch.as_tensor(np.asarray(k_offset) if not isinstance(
        k_offset, torch.Tensor) else k_offset)
    t = t.to(device=device, dtype=torch.int32).reshape(-1)
    if t.numel() == 1:
        return t.expand(n_tiles).contiguous()
    if t.numel() != n_tiles:
        raise ValueError(f"k_offset has {t.numel()} entries for {n_tiles} "
                         f"tiles")
    return t.contiguous()


def shard_plan(dplan: DevicePlan, starts=None, counts=None, k_line=None,
               frac0=None, k_offset=None, n_tiles=None,
               n_out=None) -> DevicePlan:
    """``dplan`` with the shard-local overrides of ``xsect_pallas``
    (``pallas_xsect.py:1740-1800``): the shard's ``starts``/``counts`` (one
    per shard tile), its slots' ``k_line``/``frac0``, its tiles'
    ``k_offset`` (a scalar for a contiguous shard or one global grid offset
    per tile), ``n_tiles`` and ``n_out`` (the shard's points). Arrays go to
    the plan's device without a host round trip; ``dplan`` itself when
    nothing is overridden."""
    if all(v is None for v in (starts, counts, k_line, frac0, k_offset,
                               n_tiles, n_out)):
        return dplan
    dev = dplan.k_line.device
    i32 = lambda a: torch.as_tensor(a).to(  # noqa: E731
        device=dev, dtype=torch.int32).reshape(-1).contiguous()
    nt = dplan.n_tiles if n_tiles is None else int(n_tiles)
    kw = dict(n_tiles=nt)
    if starts is not None:
        kw["starts"] = i32(starts)
    if counts is not None:
        kw["counts"] = i32(counts)
    if k_line is not None:
        kw["k_line"] = i32(k_line)
    if frac0 is not None:
        kw["frac0"] = torch.as_tensor(frac0).to(
            device=dev, dtype=dplan.frac0.dtype).reshape(-1).contiguous()
    if n_out is not None:
        kw["n_out"] = int(n_out)
    if k_offset is not None:
        kw["tile_off"] = _offsets(k_offset, nt, dev)
    elif nt != dplan.n_tiles and dplan.tile_off is not None:
        raise ValueError("n_tiles changes the tiles of a plan with offsets; "
                         "pass their k_offset")
    return dataclasses.replace(dplan, **kw)


def _shardable(fn):
    """``fn(dplan, ...)`` that also takes the shard-local overrides of
    :func:`shard_plan` as keywords, applied to ``dplan`` first."""

    @functools.wraps(fn)
    def wrapped(dplan, *args, starts=None, counts=None, k_line=None,
                frac0=None, k_offset=None, n_tiles=None, n_out=None, **kw):
        return fn(shard_plan(dplan, starts, counts, k_line, frac0, k_offset,
                             n_tiles, n_out), *args, **kw)

    return wrapped


def device_plan(plan: BucketPlan, line_idx, nu0, device=None,
                dtype=torch.float32) -> DevicePlan:
    """Move ``plan`` to ``device`` (None: the card); ``line_idx`` maps the
    plan's line list (the call's lines) to rows of the full (nLay, L)
    parameter arrays, whose float64 host centres are ``nu0``. A packed
    plan's slots hold the lines of its gather; a shared-block plan's slot
    ``block * B + s`` holds line ``block * B + s``, and the slots beyond
    the line list are padding (line -1).

    ``frac0`` is the plan's float32 fraction for float32 runs; a float64 run
    recomputes it from ``nu0`` in float64, so its line positions carry no
    float32 rounding (~3e-8 grid units) either.
    """
    device = resolve_device(device)
    line_idx = np.asarray(line_idx, dtype=np.int64)
    if plan.gather is None:
        g = np.arange(plan.n_blocks * plan.block, dtype=np.int64)
        g = np.where(g < line_idx.size, g, -1)
    else:
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


def _cpf3_pair(x, y):
    """(Re, Im) of hapi's 15-term asymptotic CPF (``cpf3``,
    ``misc/hapi.py:9645-9670``; ``pallas_xsect.py::_cpf3_pair``) in real
    arithmetic, |z|^2 clamped at 9 so that unselected evaluations at small
    |z| stay finite."""
    m = torch.clamp(x * x + y * y, min=9.0)
    ar = x / m
    ai = -y / m
    m2r = ar * ar - ai * ai
    m2i = 2.0 * ar * ai
    sr = torch.ones_like(ar)
    si = torch.zeros_like(ar)
    tr, ti = torch.ones_like(ar), torch.zeros_like(ar)
    for tt in (0.5, 1.5, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5, 8.5, 9.5, 10.5,
               11.5, 12.5, 13.5, 14.5):
        tr, ti = (tr * m2r - ti * m2i) * tt, (tr * m2i + ti * m2r) * tt
        sr = sr + tr
        si = si + ti
    return (-(ar * si + ai * sr) * _INV_SQRT_PI,
            (ar * sr - ai * si) * _INV_SQRT_PI)


def _cpf3_re_w(x, y):
    """Re w of :func:`_cpf3_pair`."""
    return _cpf3_pair(x, y)[0]


def _voigt_w_KL(x, y, a, L):
    """(Re w, Im w) with hum1_wei's region blend, y elementwise
    (``pallas_xsect.py::_voigt_w_KL``): the Weideman series inside
    |x| + y < 15, the unguarded asymptotic form outside."""
    dr = 0.5 + y * y - x * x
    di = -2.0 * x * y
    inv = _INV_SQRT_PI * (1.0 / (dr * dr + di * di))
    Ka = (y * dr - x * di) * inv
    La = -(x * dr + y * di) * inv
    Kw, Lw = _weideman_w(x, y, a, L)
    in_core = (torch.abs(x) + y) < REGION_BOUND
    return torch.where(in_core, Kw, Ka), torch.where(in_core, Lw, La)


def _re_w_select(x, y, a, L):
    """Re w by hum1_wei's region rule (Weideman inside |x| + y < 15, the
    unguarded asymptotic form outside)."""
    return torch.where(torch.abs(x) + y < REGION_BOUND,
                       _weideman_w(x, y, a, L)[0], _asym_re_w(x, y))


def _sdvoigt_block(dnu, gd, g0, g2, s0, a, L, variant="full"):
    """SD-Voigt profile (``pallas_xsect.py::_sdvoigt_block``): pcqsdhc with
    anuVC = eta = Shift2 = 0 and Gamma2 real, op for op. ``variant``
    'full' is hapi's CPF3-vs-CPF selection, 'asym' both CPF points in the
    guarded asymptotic form, 'core' their difference."""
    cte = _SQRT_LN2 / gd
    # runtime-vanishing Gamma2 is clamped to the Voigt limit
    g2 = torch.maximum(g2, 1e-4 * g0 + 1e-12)
    inv_g2 = 1.0 / g2
    c0tr = (g0 - 1.5 * g2) * inv_g2
    xi = (s0 - dnu) * inv_g2
    c = 0.5 / (cte * g2)
    aa = c0tr + c * c
    r = torch.sqrt(aa * aa + xi * xi)
    u = torch.sqrt(torch.clamp((r + aa) * 0.5, min=0.0))
    v = torch.sign(xi) * torch.sqrt(torch.clamp((r - aa) * 0.5, min=0.0))
    x12 = -v
    y1 = u - c
    y2 = u + c
    if variant == "asym":
        return cte * _INV_SQRT_PI * (_asym_re_w(x12, y1, _GUARD)
                                     - _asym_re_w(x12, y2, _GUARD))
    sz1 = torch.sqrt(v * v + y1 * y1)
    sz2 = torch.sqrt(v * v + y2 * y2)
    szmx = torch.maximum(sz1, sz2)
    szmn = torch.minimum(sz1, sz2)
    use3 = (torch.abs(sz1 - sz2) <= 1.0) & (szmx > 8.0) & (szmn <= 8.0)
    w1 = torch.where(use3, _cpf3_re_w(x12, y1), _re_w_select(x12, y1, a, L))
    w2 = torch.where(use3, _cpf3_re_w(x12, y2), _re_w_select(x12, y2, a, L))
    if variant == "core":
        w1 = w1 - _asym_re_w(x12, y1, _GUARD)
        w2 = w2 - _asym_re_w(x12, y2, _GUARD)
    return cte * _INV_SQRT_PI * (w1 - w2)


def _simple_profile(mode, dnu, gd, g0, strength):
    """Lorentz or Doppler contribution, hapi's forms with its truncated
    Doppler constants (``pallas_xsect.py::_simple_profile``)."""
    if mode == "lorentz":
        return strength * g0 * (_INV_PI * (1.0 / (g0 * g0 + dnu * dnu)))
    inv_gd = 1.0 / gd
    t = dnu * inv_gd
    return ((strength * SQRT_LN2_DIV_SQRT_PI) * inv_gd
            * torch.exp(-LN2 * t * t))


def _value(kind, u, s, a, L):
    """One slot's contribution at grid offsets ``u`` before the window
    mask: ``kind`` is a mode of :data:`MODES` or 'voigtfull' (the
    correction passes' blend, guarded outside the core); ``s`` holds the
    slot constants of :func:`_slot_constants`."""
    if kind in SD_MODES:
        variant = {"sdvoigt": "full", "sdvoigt_asym": "asym",
                   "sdvoigt_core": "core"}[kind]
        return s["s"] * _sdvoigt_block((u - s["ds"]) * s["dx"], s["gd"],
                                       s["g0"], s["g2"], s["s0"], a, L,
                                       variant)
    if kind in ("lorentz", "doppler"):
        return _simple_profile(kind, (u - s["ds"]) * s["dx"], s["gd"],
                               s["g0"], s["s"])
    x, y = (u - s["ds"]) * s["xs"], s["y"]
    if kind == "asym":
        return s["scale"] * _asym_re_w(x, y, _GUARD)
    if kind == "full":
        return s["scale"] * _select_core(
            x, y, lambda xc, yc: _weideman_w(xc, yc, a, L),
            lambda xf, yf: (_asym_re_w(xf, yf),))[0]
    in_core = (torch.abs(x) + y) < REGION_BOUND
    Kw, Lw = _weideman_w(x, y, a, L)
    if kind == "core":
        return s["scale"] * torch.where(in_core, Kw - _asym_re_w(x, y, _GUARD),
                                        0.0)
    if kind == "voigtfull":
        return s["scale"] * torch.where(in_core, Kw,
                                        _asym_re_w(x, y, _GUARD))
    dr = 0.5 + y * y - x * x
    di = -2.0 * x * y
    inv = _INV_SQRT_PI * (1.0 / (dr * dr + di * di))
    Ka = (y * dr - x * di) * inv
    La = -(x * dr + y * di) * inv
    return s["scale"] * (torch.where(in_core, Kw, Ka)
                         + s["ymix"] * torch.where(in_core, Lw, La))


def _asym_k_grads(x, y):
    """(K, dK/dx, dK/dy) of the unguarded asymptotic form: the derivative
    of the approximation (``pallas_xsect.py::_asym_K_grads``), not the
    exact-Faddeeva identity, which cancels ~4 digits in the far wing."""
    dr = 0.5 + y * y - x * x
    di = -2.0 * x * y
    inv = 1.0 / (dr * dr + di * di)
    K = _INV_SQRT_PI * (y * dr - x * di) * inv
    nr = 0.5 + x * x - y * y
    ni = -di
    d2r = dr * dr - di * di
    d2i = 2.0 * dr * di
    inv2 = inv * inv
    mr = nr * d2r + ni * d2i
    mi = ni * d2r - nr * d2i
    return K, _INV_SQRT_PI * mi * inv2, _INV_SQRT_PI * mr * inv2


def _weideman_k_grads(x, y, a, L):
    """(K, dK/dx, dK/dy) of the Weideman series, P' by a second Horner
    accumulator (``pallas_xsect.py::_weideman_K_grads``)."""
    er, ei = L + y, -x
    inv_e = 1.0 / (er * er + ei * ei)
    ier, iei = er * inv_e, -ei * inv_e
    nr, ni = L - y, x
    zr = (nr * er + ni * ei) * inv_e
    zi = (ni * er - nr * ei) * inv_e
    pr = torch.full_like(zr, float(a[0]))
    pi_ = torch.zeros_like(zr)
    qr = torch.zeros_like(zr)
    qi = torch.zeros_like(zr)
    for c in a[1:]:
        qr, qi = qr * zr - qi * zi + pr, qr * zi + qi * zr + pi_
        pr, pi_ = pr * zr - pi_ * zi + float(c), pr * zi + pi_ * zr
    i2r, i2i = ier * ier - iei * iei, 2.0 * ier * iei
    i3r, i3i = i2r * ier - i2i * iei, i2r * iei + i2i * ier
    i4r, i4i = i2r * i2r - i2i * i2i, 2.0 * i2r * i2i
    K = 2.0 * (pr * i2r - pi_ * i2i) + _INV_SQRT_PI * ier
    c4 = 4.0 * L
    Qr = (c4 * (qr * i4r - qi * i4i) + 4.0 * (pr * i3r - pi_ * i3i)
          + _INV_SQRT_PI * i2r)
    Qi = (c4 * (qr * i4i + qi * i4r) + 4.0 * (pr * i3i + pi_ * i3r)
          + _INV_SQRT_PI * i2i)
    return K, -Qi, -Qr


def _select_core(x, y, core_fn, far_fn):
    """The hum1_wei region blend: ``core_fn`` where |x| + y < 15, ``far_fn``
    elsewhere, each returning a tuple of tensors. ``core_fn`` runs on the
    in-core elements only (the forms are elementwise, so the values are
    those of a ``torch.where`` over both, at a fraction of the work)."""
    y = y.expand_as(x)
    in_core = (torch.abs(x) + y) < REGION_BOUND
    out = far_fn(x, y)
    for f, c in zip(out, core_fn(x[in_core], y[in_core])):
        f[in_core] = c
    return out


def _voigt_k_grads(x, y, a, L):
    """(K, dK/dx, dK/dy) with the hum1_wei region blend ('full' mode)."""
    return _select_core(x, y,
                        lambda xc, yc: _weideman_k_grads(xc, yc, a, L),
                        _asym_k_grads)


def _slot_constants(dplan, lay_idx, shift0, strength, gamma_d, gamma_0, wing,
                    ymix, mode, gamma_2=None):
    """(nl, n_slots) per-(layer, slot) line constants, padding slots filled
    as the Pallas wrapper pads them (strength 0, gammas 1, shift 0, wing 0).
    SD-Voigt modes have a zero grid shift ``ds`` and the shift ``s0`` inside
    the profile; a correction pass masks by the true window (no wing cap).
    ``gd`` and ``cte`` also feed the tangent's coefficients."""
    fam = parse_mode(mode)[0]
    sd = is_sd_mode(mode)
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
    w = wing[lay][:, safe]
    if fam != "corr":
        w = torch.minimum(w, dplan.wcap.to(dt))
    c = dict(
        gd=gd, cte=cte, dx=dx,
        ds=(torch.zeros_like(gd) if sd else take(shift0 / dx, 0.0)),
        xs=dx * cte,
        y=take(gamma_0, 1.0) * cte,
        scale=take(strength, 0.0) * (_INV_SQRT_PI * cte),
        wingu=torch.where(valid, w / dx,
                          torch.tensor(0.0, dtype=dt, device=wing.device)),
        ymix=take(ymix, 1.0) if mode == "mix" else None,
    )
    if sd or fam in ("lorentz", "doppler"):
        c.update(s=take(strength, 0.0), g0=take(gamma_0, 1.0),
                 s0=take(shift0, 0.0),
                 g2=take(gamma_2, 1.0) if sd else None)
    return c


def _tile_start(dplan, t_i):
    """(n_t,) int32 global grid index of the first point of tiles
    ``t_i``: i*tile plus the tile's offset."""
    k0 = t_i.to(torch.int32) * dplan.tile
    return k0 if dplan.tile_off is None else k0 + dplan.tile_off[t_i]


def _plain_steps(dplan, n_rows, dt):
    """The plain versions' walk over a plan: for each block position j, the
    tiles with more than j blocks, in chunks of about ``_PLAIN_MAX_ELEMS``
    (row, slot, point) elements; yields (tile indices, (n_t, block) slot
    indices, (1, n_t, block, tile) u in grid units, at the tiles' global
    grid indices)."""
    dev, tile, block = dplan.k_line.device, dplan.tile, dplan.block
    kk = torch.arange(tile, dtype=torch.int32, device=dev)
    bb = torch.arange(block, dtype=torch.int64, device=dev)
    counts = dplan.counts.long()
    chunk = max(1, _PLAIN_MAX_ELEMS // (n_rows * block * tile))
    for j in range(dplan.max_blocks):
        tiles = torch.nonzero(counts > j).reshape(-1)
        for lo in range(0, tiles.numel(), chunk):
            t_i = tiles[lo:lo + chunk]
            slots = (dplan.starts.long()[t_i] + j)[:, None] * block + bb
            k_grid = (_tile_start(dplan, t_i)[:, None] + kk)[:, None, :]
            rel = (k_grid - dplan.k_line[slots][:, :, None]).to(dt)
            u = rel - dplan.frac0.to(dt)[slots][:, :, None]
            yield t_i, slots, u[None]


def cubic_weights(n, R, dt, dev):
    """For fine points i = 0 .. n-1: the segment i // R (the first of the
    four coarse nodes each interpolates) and the uniform 4-point
    Lagrange-cubic weights at t = frac(i / R), the stencil the coarse-far
    upsample (``products/od.py::_coarse_upsample``) and the correction
    passes share (``pallas_xsect.py:798-811``)."""
    i = torch.arange(n, device=dev)
    seg = i // R
    t = (i - seg * R).to(dt) / R
    return seg, ((-t * (t - 1.0) * (t - 2.0) * (1.0 / 6.0)),
                 ((t * t - 1.0) * (t - 2.0) * 0.5),
                 (-t * (t + 1.0) * (t - 2.0) * 0.5),
                 (t * (t * t - 1.0) * (1.0 / 6.0)))


@_shardable
def xsect_fused_plain(dplan: DevicePlan, lay_idx, shift0, strength, gamma_d,
                      gamma_0, wing, ymix=None, mode: str = "asym",
                      n_weideman: int = 16, gamma_2=None) -> torch.Tensor:
    """Plain PyTorch version of the fused kernel, in the parameters' dtype
    (float32 or float64) on their device.

    Parameters are (nLay, L) rows over the full line list; ``lay_idx``
    selects this call's layers. For each tile and each of its blocks it
    evaluates the dense (layers, block, tile) line shapes, masks them to
    hapi's window and sums over the block. A correction pass ``corr:R:*``
    adds, per slot, the masked point term minus the cubic interpolation of
    the masked guarded-asymptotic node values (nodes every R points, row 0
    one coarse step left of the tile start) at every point of the tile.
    Returns (len(lay_idx), n_out).
    """
    _check_mode_args(mode, ymix, gamma_2)
    fam, R, variant = parse_mode(mode)
    dt, dev = strength.dtype, strength.device
    c = _slot_constants(dplan, lay_idx, shift0, strength, gamma_d, gamma_0,
                        wing, ymix, mode, gamma_2)
    nl = c["xs"].shape[0]
    L_w, a_w = weideman_coeffs(n_weideman)
    keys = [k for k, v in c.items() if isinstance(v, torch.Tensor)]
    if fam == "corr":
        if dplan.tile % R:
            raise ValueError(f"{mode}: the tile ({dplan.tile}) must be a "
                             f"multiple of R")
        _check_corr_offsets(dplan, mode, R)
        sd = variant.startswith("sd")
        pt_kind = {"voigt": "asym", "voigtfull": "voigtfull",
                   "sdvoigt": "sdvoigt_asym",
                   "sdvoigtfull": "sdvoigt"}[variant]
        nd_kind = "sdvoigt_asym" if sd else "asym"
        seg, wts = cubic_weights(dplan.tile, R, dt, dev)
        nodes = (torch.arange(dplan.tile // R + 3, device=dev) - 1) * R
    out = torch.zeros((nl, dplan.n_tiles, dplan.tile), dtype=dt, device=dev)
    for t_i, slots, u in _plain_steps(dplan, nl, dt):
        s = {k: c[k][:, slots][..., None] for k in keys}
        s["dx"] = c["dx"]
        win = lambda uu: (uu > -s["wingu"]) & (uu <= s["wingu"])  # noqa
        if fam != "corr":
            val = _value(mode, u, s, a_w, L_w)
            out[:, t_i] += torch.where(win(u), val, 0.0).sum(dim=2)
            continue
        k_nodes = (_tile_start(dplan, t_i)[:, None]
                   + nodes.to(torch.int32))[:, None, :]
        u_n = ((k_nodes - dplan.k_line[slots][:, :, None]).to(dt)
               - dplan.frac0.to(dt)[slots][:, :, None])[None]
        v_n = torch.where(win(u_n), _value(nd_kind, u_n, s, a_w, L_w), 0.0)
        interp = (v_n[..., seg] * wts[0] + v_n[..., seg + 1] * wts[1]
                  + v_n[..., seg + 2] * wts[2] + v_n[..., seg + 3] * wts[3])
        fm = torch.where(win(u), _value(pt_kind, u, s, a_w, L_w), 0.0)
        out[:, t_i] += (fm - interp).sum(dim=2)
    return out.reshape(nl, -1)[:, :dplan.n_out]


def _check_corr_offsets(dplan, mode, R):
    """A correction pass's node rows lie every R points from each tile's
    global first point: raise unless every tile offset is a multiple of R
    (so that they stay on the global coarse grid the far field lives on;
    every builder's offsets are multiples of the tile)."""
    if dplan.tile_off is not None and bool((dplan.tile_off % R).ne(0).any()):
        raise ValueError(f"{mode}: tile offsets must be multiples of R "
                         f"({R}), or the node rows leave the coarse grid")


def _check_mode_args(mode, ymix, gamma_2):
    """Raise on an unknown mode or a mode's missing extra parameters."""
    parse_mode(mode)
    if mode == "mix" and ymix is None:
        raise ValueError("mode 'mix' needs the mixing coefficients ymix")
    if is_sd_mode(mode) and gamma_2 is None:
        raise ValueError(f"mode {mode!r} needs the SD widths gamma_2")


@_shardable
def xsect_fused_jvp_plain(dplan: DevicePlan, lay_idx, shift0, strength,
                          gamma_d, gamma_0, wing, shift0_t, strength_t,
                          gamma_d_t, gamma_0_t,
                          n_weideman: int = 16) -> torch.Tensor:
    """Plain PyTorch version of the tangent kernel K3, in the parameters'
    dtype on their device: the directional derivative of the ``full`` pass
    for each of nd directions.

    The primal parameters are (nLay, L) rows as in :func:`xsect_fused_plain`;
    the tangents ``*_t`` are (nd, nLay, L). With A = cte/sqrt(pi), cte =
    sqrt(ln2)/gamma_d, sA = strength A and (K, Kx, Ky) the region-consistent
    Voigt value and derivatives at (x, y), each in-window slot adds
    s_t A K - gd_t (sA/gd)(K + x Kx + y Ky) + g0_t (sA cte) Ky
    - ds_t (sA dx cte) Kx, ds_t = shift0_t/dx (JAX's grouping,
    ``pallas_xsect.py:1271-1274``). Returns (nd, len(lay_idx), n_out).
    """
    dt, dev = strength.dtype, strength.device
    c = _slot_constants(dplan, lay_idx, shift0, strength, gamma_d, gamma_0,
                        wing, None, "full")
    nd, nl = strength_t.shape[0], c["xs"].shape[0]
    lay = lay_idx.long()
    valid = dplan.line >= 0
    safe = torch.where(valid, dplan.line, 0).long()

    def take_t(a):
        return torch.where(valid, a[:, lay][:, :, safe],
                           torch.zeros((), dtype=dt, device=dev))

    cte, gd, sA = c["cte"], c["gd"], c["scale"]
    co = dict(s=take_t(strength_t) * (_INV_SQRT_PI * cte),
              gd=take_t(gamma_d_t) * (sA / gd),
              g0=take_t(gamma_0_t) * (sA * cte),
              ds=take_t(shift0_t / dplan.dx) * (sA * c["xs"]))
    L_w, a_w = weideman_coeffs(n_weideman)
    out = torch.zeros((nd, nl, dplan.n_tiles, dplan.tile), dtype=dt,
                      device=dev)
    for t_i, slots, u in _plain_steps(dplan, nl * (nd + 1), dt):
        s = {k: c[k][:, slots][..., None] for k in ("ds", "xs", "y", "wingu")}
        x, y = (u - s["ds"]) * s["xs"], s["y"]
        K, Kx, Ky = _voigt_k_grads(x, y, a_w, L_w)
        G = K + x * Kx + y * Ky
        t = {k: v[:, :, slots][..., None] for k, v in co.items()}
        tan = t["s"] * K - t["gd"] * G + t["g0"] * Ky - t["ds"] * Kx
        mask = (u > -s["wingu"]) & (u <= s["wingu"])
        out[:, :, t_i] += torch.where(mask, tan, 0.0).sum(dim=3)
    return out.reshape(nd, nl, -1)[:, :, :dplan.n_out]


@_shardable
def xsect_sdvoigt_jvp_plain(dplan: DevicePlan, lay_idx, shift0, strength,
                            gamma_d, gamma_0, gamma_2, wing, shift0_t,
                            strength_t, gamma_d_t, gamma_0_t, gamma_2_t,
                            n_weideman: int = 16) -> torch.Tensor:
    """Plain PyTorch version of the SD-Voigt tangent kernel K4, in the
    parameters' dtype on their device: the directional derivative of the
    single-pass ``sdvoigt`` pass w.r.t. (strength, gamma_d, gamma_0,
    gamma_2, shift0) for each of nd directions, by the analytic formula of
    ``pallas_xsect.py:1382-1421`` in its order of operations.

    With X = (Gamma0 - 1.5 Gamma2 + i (Shift0 - dnu))/Gamma2, c = GammaD /
    (2 sqrt(ln2) Gamma2), S = sqrt(X + c^2) = us + i vs and the CPF points
    Z1,2 = S -+ c at (x, y) = (-vs, us -+ c): dX = [dGamma0 - (1.5 + X)
    dGamma2 + i dShift0]/Gamma2, dc = c (dGammaD/GammaD - dGamma2/Gamma2),
    dS = (dX + 2 c dc)/(2 S), dK(Z) = Kx (-Im dZ) + Ky Re dZ with the
    region-consistent (K, Kx, Ky) of the Weideman/asymptotic blend (also
    inside the CPF3 sub-band, as JAX's kernel). The Voigt-limit clamp
    Gamma2 -> max(Gamma2, 1e-4 Gamma0 + 1e-12) passes dGamma2 where Gamma2
    is above it and 1e-4 dGamma0 where clamped. Primal parameters (nLay,
    L), tangents (nd, nLay, L); returns (nd, len(lay_idx), n_out).
    """
    dt, dev = strength.dtype, strength.device
    c = _slot_constants(dplan, lay_idx, shift0, strength, gamma_d, gamma_0,
                        wing, None, "sdvoigt", gamma_2)
    nd, nl = strength_t.shape[0], c["xs"].shape[0]
    lay = lay_idx.long()
    valid = dplan.line >= 0
    safe = torch.where(valid, dplan.line, 0).long()

    def take_t(a):
        return torch.where(valid, a[:, lay][:, :, safe],
                           torch.zeros((), dtype=dt, device=dev))

    tans = dict(s=take_t(strength_t), gd=take_t(gamma_d_t),
                g0=take_t(gamma_0_t), g2=take_t(gamma_2_t),
                s0=take_t(shift0_t))
    L_w, a_w = weideman_coeffs(n_weideman)
    out = torch.zeros((nd, nl, dplan.n_tiles, dplan.tile), dtype=dt,
                      device=dev)
    for t_i, slots, u in _plain_steps(dplan, nl * (nd + 1) * 4, dt):
        p = {k: c[k][:, slots][..., None]
             for k in ("s", "gd", "g0", "g2", "s0", "wingu")}
        t = {k: v[:, :, slots][..., None] for k, v in tans.items()}
        dnu = u * dplan.dx
        cte = _SQRT_LN2 / p["gd"]
        clamp = 1e-4 * p["g0"] + 1e-12
        g2 = torch.maximum(p["g2"], clamp)
        g2e_t = torch.where(p["g2"] >= clamp, t["g2"], 1e-4 * t["g0"])
        inv_g2 = 1.0 / g2
        xr = (p["g0"] - 1.5 * g2) * inv_g2
        xi = (p["s0"] - dnu) * inv_g2
        cc = 0.5 / (cte * g2)
        aa = xr + cc * cc
        r = torch.sqrt(aa * aa + xi * xi)
        us = torch.sqrt(torch.clamp((r + aa) * 0.5, min=0.0))
        vs = torch.sign(xi) * torch.sqrt(torch.clamp((r - aa) * 0.5,
                                                     min=0.0))
        x12 = -vs
        K1, Kx1, Ky1 = _voigt_k_grads(x12, us - cc, a_w, L_w)
        K2, Kx2, Ky2 = _voigt_k_grads(x12, us + cc, a_w, L_w)
        dXr = inv_g2 * (t["g0"] - (1.5 + xr) * g2e_t)
        dXi = inv_g2 * (t["s0"] - xi * g2e_t)
        dc = cc * (t["gd"] / p["gd"] - inv_g2 * g2e_t)
        num_r = dXr + 2.0 * cc * dc
        den = 2.0 * torch.clamp(us * us + vs * vs, min=1e-30)
        dSr = (num_r * us + dXi * vs) / den
        dSi = (dXi * us - num_r * vs) / den
        dK1 = Kx1 * (-dSi) + Ky1 * (dSr - dc)
        dK2 = Kx2 * (-dSi) + Ky2 * (dSr + dc)
        A = _INV_SQRT_PI * cte
        dK12 = K1 - K2
        tan = (t["s"] * A * dK12 - t["gd"] * (p["s"] * A / p["gd"]) * dK12
               + p["s"] * A * (dK1 - dK2))
        mask = (u > -p["wingu"]) & (u <= p["wingu"])
        out[:, :, t_i] += torch.where(mask, tan, 0.0).sum(dim=3)
    return out.reshape(nd, nl, -1)[:, :, :dplan.n_out]


# --------------------------------------------------------------------------
# the CUDA kernel's wrapper
# --------------------------------------------------------------------------

@functools.lru_cache(maxsize=8)
def _weideman_table(n: int, device) -> torch.Tensor:
    """[L, a_0 .. a_{n-1}] as float32 on ``device`` (the kernel's table)."""
    L, a = weideman_coeffs(n)
    return torch.tensor([L, *a], dtype=torch.float32, device=device)


def _off_ptr(dplan: DevicePlan):
    """The tile offsets' pointer for a launch (None: the kernels' zero)."""
    return None if dplan.tile_off is None else dplan.tile_off.data_ptr()


def _count(key: str, dplan: DevicePlan):
    """Count a launch under ``key`` (and under ``OFFSET_LAUNCHES`` when
    its tiles carry grid offsets)."""
    LAUNCHES[key] += 1
    if dplan.tile_off is not None:
        OFFSET_LAUNCHES[key] += 1


def _check_call(dplan: DevicePlan, lay_idx, params: dict, n_weideman: int):
    """Raise unless the arguments are what the kernels' raw pointers
    assume: float32 (nLay, L) parameters, int32 layer indices and a
    consistent plan, all on one CUDA device."""
    strength = params["strength"]
    if strength.device.type != "cuda":
        raise ValueError(f"unsupported device {strength.device}")
    dev = strength.device
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
    if dplan.tile_off is not None:
        check_tensor("tile_off", dplan.tile_off, torch.int32, dev,
                     (dplan.n_tiles,))
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


@_shardable
def xsect_fused(dplan: DevicePlan, lay_idx, shift0, strength, gamma_d,
                gamma_0, wing, ymix=None, mode: str = "asym",
                n_weideman: int = 16, gamma_2=None) -> torch.Tensor:
    """One fused line-shape pass: (len(lay_idx), n_out) float32.

    ``mode`` is one of :data:`MODES` or ``corr:R:<variant>``; ``mix`` needs
    ``ymix`` and the SD-Voigt modes ``gamma_2`` ((nLay, L) like the other
    parameters). CPU tensors run :func:`xsect_fused_plain`. CUDA tensors
    launch the CUDA kernel on the current stream; anything it does not take
    (another dtype than float32, non-contiguous or mismatched shapes, mixed
    devices, a correction pass whose R does not divide the kernel's
    256-point slice and the tile, or is below 8) raises, as does a non-zero
    CUDA error from the launch.
    """
    _check_mode_args(mode, ymix, gamma_2)
    if strength.device.type == "cpu":
        return xsect_fused_plain(dplan, lay_idx, shift0, strength, gamma_d,
                                 gamma_0, wing, ymix, mode, n_weideman,
                                 gamma_2)
    fam, R, variant = parse_mode(mode)
    params = dict(shift0=shift0, strength=strength, gamma_d=gamma_d,
                  gamma_0=gamma_0, wing=wing)
    if mode == "mix":
        params["ymix"] = ymix
    if is_sd_mode(mode):
        params["gamma_2"] = gamma_2
    _check_call(dplan, lay_idx, params, n_weideman)
    if fam == "corr" and (not corr_r_supported(R) or dplan.tile % R):
        raise ValueError(f"{mode}: the CUDA correction pass needs an R that "
                         f"divides its {_SPAN}-point slice and the tile "
                         f"({dplan.tile}) and is at least {_CORR_MIN_R}")
    if fam == "corr":
        _check_corr_offsets(dplan, mode, R)
    dev = strength.device
    n_lay_call = lay_idx.numel()
    n_lines = strength.shape[1]
    out = torch.empty((n_lay_call, dplan.n_out), dtype=torch.float32,
                      device=dev)
    if n_lay_call == 0 or dplan.n_out == 0:
        return out
    wei = _weideman_table(n_weideman, dev)
    code = (len(MODES) + CORR_VARIANTS.index(variant) if fam == "corr"
            else MODES.index(mode))
    err = _build.library().radtxfr_fused_xsect(
        code, R, dplan.starts.data_ptr(), dplan.counts.data_ptr(),
        dplan.k_line.data_ptr(), dplan.frac0.data_ptr(),
        dplan.line.data_ptr(), dplan.wcap.data_ptr(), _off_ptr(dplan),
        lay_idx.data_ptr(), n_lay_call, shift0.data_ptr(),
        strength.data_ptr(),
        gamma_d.data_ptr(), gamma_0.data_ptr(), wing.data_ptr(),
        params.get("ymix", strength).data_ptr(),
        params.get("gamma_2", strength).data_ptr(), n_lines,
        wei.data_ptr(), n_weideman, dplan.tile, dplan.block, dplan.n_tiles,
        dplan.max_blocks, dplan.n_out, dplan.dx, out.data_ptr(),
        _build.launch_stream(dev))
    if err != 0:
        raise RuntimeError(f"fused_xsect kernel ({mode}) launch failed with "
                           f"CUDA error {err}")
    _count(mode, dplan)
    return out


def _tangent_launches(symbol: str, key: str, dplan: DevicePlan, lay_idx,
                      params: dict, tangents: dict,
                      n_weideman: int) -> torch.Tensor:
    """Check the arguments of a tangent kernel (K3, K4 or the HT tangent
    K6) and launch it once per ``_JVP_MAX_DIRS`` directions on the current
    stream: ``params`` (nLay, L) and ``tangents`` (nd, nLay, L), each in the
    order of the C function ``symbol``, which takes the launch's rows of
    :func:`live_directions`; (nd, len(lay_idx), n_out) float32. Launches
    count under ``key``."""
    _check_call(dplan, lay_idx, params, n_weideman)
    strength, strength_t = params["strength"], tangents["strength_t"]
    dev = strength.device
    nd = strength_t.shape[0] if strength_t.dim() == 3 else -1
    for name, t in tangents.items():
        check_tensor(name, t, torch.float32, dev,
                     (nd,) + tuple(strength.shape))
    n_lay_call = lay_idx.numel()
    n_lay, n_lines = strength.shape
    out = torch.empty((nd, n_lay_call, dplan.n_out), dtype=torch.float32,
                      device=dev)
    if nd == 0 or n_lay_call == 0 or dplan.n_out == 0:
        return out
    wei = _weideman_table(n_weideman, dev)
    live = live_directions(tangents.values(), n_lay)
    per_dir = n_lay * n_lines * 4
    for d0 in range(0, nd, _JVP_MAX_DIRS):
        n = min(_JVP_MAX_DIRS, nd - d0)
        err = getattr(_build.library(), symbol)(
            dplan.starts.data_ptr(), dplan.counts.data_ptr(),
            dplan.k_line.data_ptr(), dplan.frac0.data_ptr(),
            dplan.line.data_ptr(), dplan.wcap.data_ptr(), _off_ptr(dplan),
            lay_idx.data_ptr(), n_lay_call, live[d0].data_ptr(),
            *(p.data_ptr() for p in params.values()),
            *(t.data_ptr() + d0 * per_dir for t in tangents.values()),
            n, n_lay, n_lines, wei.data_ptr(), n_weideman, dplan.tile,
            dplan.block, dplan.n_tiles, dplan.n_out, dplan.dx,
            out[d0].data_ptr(), _build.launch_stream(dev))
        if err != 0:
            raise RuntimeError(f"{symbol} kernel launch failed with CUDA "
                               f"error {err}")
        _count(key, dplan)
    return out


@_shardable
def xsect_fused_jvp(dplan: DevicePlan, lay_idx, shift0, strength, gamma_d,
                    gamma_0, wing, shift0_t, strength_t, gamma_d_t,
                    gamma_0_t, n_weideman: int = 16) -> torch.Tensor:
    """The tangent of one ``full`` pass for nd directions:
    (nd, len(lay_idx), n_out) float32 from (nd, nLay, L) tangents.

    CPU tensors run :func:`xsect_fused_jvp_plain`. CUDA tensors launch the
    tangent kernel (``csrc/fused_xsect_jvp.cu``, one CTA per (128-point
    slice, 4 (direction, layer) rows), the rows whose direction has no
    non-zero tangent on their layer written as zeros without staging) once
    per ``_JVP_MAX_DIRS`` directions on the current stream; anything it
    does not take raises, as does a non-zero CUDA error from a launch.
    """
    if strength.device.type == "cpu":
        return xsect_fused_jvp_plain(dplan, lay_idx, shift0, strength,
                                     gamma_d, gamma_0, wing, shift0_t,
                                     strength_t, gamma_d_t, gamma_0_t,
                                     n_weideman)
    return _tangent_launches(
        "radtxfr_fused_xsect_jvp", "jvp", dplan, lay_idx,
        dict(shift0=shift0, strength=strength, gamma_d=gamma_d,
             gamma_0=gamma_0, wing=wing),
        dict(shift0_t=shift0_t, strength_t=strength_t, gamma_d_t=gamma_d_t,
             gamma_0_t=gamma_0_t), n_weideman)


def live_directions(tangents, n_lay) -> torch.Tensor:
    """(nd, n_lay) int32: 1 where any of the (nd, n_lay, ...) ``tangents``
    of direction d is non-zero on layer l (the tangent kernels K3, K4 and
    K6 stage and evaluate only those (direction, layer) rows), computed on
    their device."""
    live = None
    for t in tangents:
        nz = (t != 0).reshape(t.shape[0], n_lay, -1).any(dim=2)
        live = nz if live is None else live | nz
    return live.to(torch.int32)


@_shardable
def xsect_sdvoigt_jvp(dplan: DevicePlan, lay_idx, shift0, strength, gamma_d,
                      gamma_0, gamma_2, wing, shift0_t, strength_t,
                      gamma_d_t, gamma_0_t, gamma_2_t,
                      n_weideman: int = 16) -> torch.Tensor:
    """The tangent of one single-pass ``sdvoigt`` pass for nd directions:
    (nd, len(lay_idx), n_out) float32 from (nd, nLay, L) tangents.

    CPU tensors run :func:`xsect_sdvoigt_jvp_plain`. CUDA tensors launch
    K4 (``csrc/fused_xsect_jvp.cu``: one CTA per (128-point slice, 4
    (direction, layer) rows), the rows whose direction has no non-zero
    tangent on their layer written as zeros without staging, a live row's
    line slots culled to those where its direction has a non-zero tangent
    and whose window meets the slice) once per ``_JVP_MAX_DIRS`` directions
    on the current stream; anything it does not take raises, as does a
    non-zero CUDA error from a launch.
    """
    if strength.device.type == "cpu":
        return xsect_sdvoigt_jvp_plain(dplan, lay_idx, shift0, strength,
                                       gamma_d, gamma_0, gamma_2, wing,
                                       shift0_t, strength_t, gamma_d_t,
                                       gamma_0_t, gamma_2_t, n_weideman)
    return _tangent_launches(
        "radtxfr_fused_sdvoigt_jvp", "sdvoigt_jvp", dplan, lay_idx,
        dict(shift0=shift0, strength=strength, gamma_d=gamma_d,
             gamma_0=gamma_0, gamma_2=gamma_2, wing=wing),
        dict(shift0_t=shift0_t, strength_t=strength_t, gamma_d_t=gamma_d_t,
             gamma_0_t=gamma_0_t, gamma_2_t=gamma_2_t), n_weideman)


# --------------------------------------------------------------------------
# the differentiable passes (torch.func.jvp / vmap)
# --------------------------------------------------------------------------

def _unbatched(name, in_dims):
    if any(d is not None for d in in_dims):
        raise NotImplementedError(
            f"{name}: vmap over the line parameters (a batch of states) is "
            "not supported; batch tangent directions instead")


def diff_pass(name: str, primal, tangent, diff):
    """A pass differentiable in forward mode, as a
    :class:`torch.autograd.Function` in the ``setup_context`` form applied
    as ``(dplan, lay_idx, n_weideman, *prm)``: ``primal(dplan, lay_idx,
    n_weideman, *prm)`` gives the value, ``tangent(dplan, lay_idx,
    n_weideman, prm, tans)`` the (nd, nl, n_out) tangents of a batch of
    directions from the (nd, nLay, L) tangents ``tans`` of ``prm[i]`` for i
    in ``diff`` (a missing tangent is zero; the other parameters', the
    wing's, are dropped: the window is piecewise constant). Under ``vmap``
    the tangent pass makes the batch of directions its kernel's direction
    axis; a batch of the parameters themselves raises."""

    class Tangent(torch.autograd.Function):
        @staticmethod
        def forward(dplan, lay_idx, n_weideman, n_prm, *tensors):
            tans = [t[None].contiguous() for t in tensors[n_prm:]]
            return tangent(dplan, lay_idx, n_weideman, tensors[:n_prm],
                           tans)[0]

        @staticmethod
        def setup_context(ctx, inputs, output):
            pass

        @staticmethod
        def vmap(info, in_dims, dplan, lay_idx, n_weideman, n_prm, *tensors):
            _unbatched(f"the {name} tangent pass", in_dims[:4 + n_prm])
            tans = [t.expand((info.batch_size,) + t.shape) if d is None
                    else t.movedim(d, 0)
                    for t, d in zip(tensors[n_prm:], in_dims[4 + n_prm:])]
            return tangent(dplan, lay_idx, n_weideman, tensors[:n_prm],
                           [t.contiguous() for t in tans]), 0

    class Pass(torch.autograd.Function):
        @staticmethod
        def forward(dplan, lay_idx, n_weideman, *prm):
            return primal(dplan, lay_idx, n_weideman, *prm)

        @staticmethod
        def setup_context(ctx, inputs, output):
            dplan, lay_idx, n_weideman, *prm = inputs
            ctx.save_for_forward(lay_idx, *prm)
            ctx.dplan, ctx.n_weideman = dplan, n_weideman

        @staticmethod
        def jvp(ctx, _dplan_t, _lay_t, _n_t, *prm_t):
            lay_idx, *prm = ctx.saved_tensors
            tans = [torch.zeros_like(prm[i]) if prm_t[i] is None else prm_t[i]
                    for i in diff]
            return Tangent.apply(ctx.dplan, lay_idx, ctx.n_weideman, len(prm),
                                 *prm, *tans)

        @staticmethod
        def vmap(info, in_dims, dplan, lay_idx, n_weideman, *prm):
            _unbatched(f"the {name} pass", in_dims)
            return primal(dplan, lay_idx, n_weideman, *prm), None

    Pass.__name__ = Pass.__qualname__ = f"_{name}Pass"
    Tangent.__name__ = Tangent.__qualname__ = f"_{name}Tangent"
    return Pass


# K1 full with K3; prm (shift0, strength, gamma_d, gamma_0, wing)
_FULL = diff_pass(
    "full",
    lambda dplan, lay, n, s0, s, gd, g0, w: xsect_fused(
        dplan, lay, s0, s, gd, g0, w, None, "full", n),
    lambda dplan, lay, n, prm, tans: xsect_fused_jvp(dplan, lay, *prm, *tans,
                                                     n),
    diff=(0, 1, 2, 3))
# K1 sdvoigt (zero grid shift) with K4; prm (shift0, strength, gamma_d,
# gamma_0, gamma_2, wing)
_SDVOIGT = diff_pass(
    "sdvoigt",
    lambda dplan, lay, n, s0, s, gd, g0, g2, w: xsect_fused(
        dplan, lay, s0, s, gd, g0, w, None, "sdvoigt", n, g2),
    lambda dplan, lay, n, prm, tans: xsect_sdvoigt_jvp(dplan, lay, *prm,
                                                       *tans, n),
    diff=(0, 1, 2, 3, 4))


@_shardable
def xsect_fused_diff(dplan: DevicePlan, lay_idx, shift0, strength, gamma_d,
                     gamma_0, wing, n_weideman: int = 16) -> torch.Tensor:
    """The ``full`` pass, differentiable in forward mode: K1 ``full`` for
    the value, K3 for ``torch.func.jvp`` tangents (a ``vmap`` over
    directions becomes K3's direction axis). (len(lay_idx), n_out)."""
    return _FULL.apply(dplan, lay_idx, n_weideman, shift0, strength, gamma_d,
                       gamma_0, wing)


@_shardable
def xsect_fused_sdvoigt_diff(dplan: DevicePlan, lay_idx, shift0, strength,
                             gamma_d, gamma_0, gamma_2, wing,
                             n_weideman: int = 16) -> torch.Tensor:
    """The single-pass ``sdvoigt`` pass, differentiable in forward mode
    (the counterpart of ``xsect_fused_sdvoigt_diff``): K1 ``sdvoigt`` for
    the value, K4 for ``torch.func.jvp`` tangents through (strength,
    gamma_d, gamma_0, gamma_2, shift0); a ``vmap`` over directions becomes
    K4's direction axis. (len(lay_idx), n_out)."""
    return _SDVOIGT.apply(dplan, lay_idx, n_weideman, shift0, strength,
                          gamma_d, gamma_0, gamma_2, wing)


# --------------------------------------------------------------------------
# the unfused kernel K7 (the prebuilt-plan route)
# --------------------------------------------------------------------------

#: K7's modes (``pallas_xsect.py::_make_kernel``); the others are K1's only
UNFUSED_MODES = ("full", "asym", "core", "lorentz", "doppler")


def _unfused_args(plan: BucketPlan, params, mode: str, n_weideman: int,
                  dtype=None):
    """The (nLay, L) parameter rows of ``params`` (1-D fields taken as one
    layer; cast to ``dtype`` and made contiguous when given), whether they
    were 1-D, and the plan on their device with slot ``s`` of a shared-block
    plan holding line ``s``; raises on a mode K7 does not evaluate or a line
    count the plan was not built for."""
    if mode not in UNFUSED_MODES:
        raise ValueError(
            f"the unfused kernel evaluates modes {UNFUSED_MODES}, got "
            f"{mode!r}: the SD-Voigt, mixing and correction modes are the "
            "fused kernel's (xsect_fused, through make_od_fn / "
            "make_xsect_fn)")
    if not 1 <= n_weideman <= _MAX_WEIDEMAN:
        raise ValueError(f"n_weideman must be in [1, {_MAX_WEIDEMAN}]")
    single = params.strength.dim() == 1
    rows = {k: torch.atleast_2d(getattr(params, k))
            for k in ("shift0", "strength", "gamma_d", "gamma_0", "wing")}
    if dtype is not None:
        rows = {k: v.to(dtype).contiguous() for k, v in rows.items()}
    n_lay, n_lines = rows["strength"].shape
    if plan.gather is None and not (
            (plan.n_blocks - 1) * plan.block < n_lines
            <= plan.n_blocks * plan.block):
        raise ValueError(f"{n_lines} lines do not fill the plan's "
                         f"{plan.n_blocks} blocks of {plan.block}")
    dt, dev = rows["strength"].dtype, rows["strength"].device
    nu0 = (torch.atleast_2d(params.nu0)[0].detach().cpu().numpy()
           if dt == torch.float64 else None)
    dplan = device_plan(plan, np.arange(n_lines), nu0, device=dev, dtype=dt)
    return rows, single, dplan


def xsect_unfused_plain(plan: BucketPlan, params, mode: str = "full",
                        n_weideman: int = 24) -> torch.Tensor:
    """Plain PyTorch version of K7 in the parameters' dtype on their device
    (the counterpart of ``xsect_pallas(plan, params,
    fused_layers=False)``): ``params`` holds (nLay, L) or (L,) tensors of
    the plan's sorted lines; (nLay, n) spectra, squeezed to (n,) for 1-D
    input. The sum is K1's (:func:`xsect_fused_plain`: per tile, block by
    block) with the wing capped at the plan's bound."""
    rows, single, dplan = _unfused_args(plan, params, mode, n_weideman)
    lay = torch.arange(rows["strength"].shape[0], dtype=torch.int32,
                       device=rows["strength"].device)
    out = xsect_fused_plain(dplan, lay, rows["shift0"], rows["strength"],
                            rows["gamma_d"], rows["gamma_0"], rows["wing"],
                            None, mode, n_weideman)
    return out[0] if single else out


def xsect_unfused(plan: BucketPlan, params, mode: str = "full",
                  n_weideman: int = 24) -> torch.Tensor:
    """Layered spectra through the unfused kernel K7 (``csrc/fused_xsect.cu``,
    the counterpart of ``xsect_pallas(..., fused_layers=False)``): ``plan``
    a :class:`BucketPlan` (shared-block from :func:`plan_buckets`, or
    packed) of the same sorted lines as ``params``, whose fields are
    (nLay, L) or (L,) tensors; ``mode`` one of :data:`UNFUSED_MODES`;
    ``n_weideman`` up to 32. Returns (nLay, n) float32, squeezed to (n,)
    for 1-D input.

    CPU tensors run :func:`xsect_unfused_plain` in their dtype. CUDA
    tensors are taken as float32 (the Pallas wrapper's cast) and launch K7
    on the current stream, one CTA per (256-point slice, 2 layers), each
    staged (slot, layer) pair culled by its integer window; a non-zero CUDA
    error from the launch raises. Launches count under
    ``"unfused_<mode>"`` in :data:`LAUNCHES`.
    """
    if params.strength.device.type == "cpu":
        return xsect_unfused_plain(plan, params, mode, n_weideman)
    rows, single, dplan = _unfused_args(plan, params, mode, n_weideman,
                                        torch.float32)
    n_lay, n_lines = rows["strength"].shape
    lay = torch.arange(n_lay, dtype=torch.int32, device=dplan.line.device)
    _check_call(dplan, lay, rows, n_weideman)
    dev = rows["strength"].device
    out = torch.empty((n_lay, dplan.n_out), dtype=torch.float32, device=dev)
    if dplan.n_out:
        err = _build.library().radtxfr_unfused_xsect(
            MODES.index(mode), dplan.starts.data_ptr(),
            dplan.counts.data_ptr(), dplan.k_line.data_ptr(),
            dplan.frac0.data_ptr(), dplan.line.data_ptr(),
            dplan.wcap.data_ptr(), lay.data_ptr(), n_lay,
            *(rows[k].data_ptr() for k in ("shift0", "strength", "gamma_d",
                                            "gamma_0", "wing")),
            n_lines, _weideman_table(n_weideman, dev).data_ptr(),
            n_weideman, dplan.tile, dplan.block, dplan.n_tiles, dplan.n_out,
            dplan.dx, out.data_ptr(),
            _build.launch_stream(dev))
        if err != 0:
            raise RuntimeError(f"unfused_xsect kernel ({mode}) launch failed "
                               f"with CUDA error {err}")
        LAUNCHES[f"unfused_{mode}"] += 1
    return out[0] if single else out
