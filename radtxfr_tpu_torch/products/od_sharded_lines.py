"""Line-sharded spectral OD: each spectral shard holds only the lines
whose windows can reach its sub-band (counterpart of
``radtxfr_tpu/products/od_sharded_lines.py``).

:func:`~.od.make_od_local_fn` replicates the whole line list on every
device; here each shard keeps its in-band lines plus a halo of boundary
lines (the reference's pad/overlap band chunking,
``radiative_transfer.py:425-455``, as data placement), so per-device line
memory and line-parameter work shrink from O(L) to O(L/S + halo). Each
shard's plans come from the plan of its lines on the whole padded grid,
restricted to its tiles; a slot's line index points into the shard's line
set, whose last entry is an inert padding line (padding slots there also
park at ``k_line = -2**30``, so no window test passes). The kernels are
K1's passes, on the shard's tiles at its grid offset.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import arrays_on
from ..kernels.fused_xsect import (DevicePlan, UniformGrid, plan_buckets,
                                   xsect_fused)
from ..lines.store import LineStore
from .od import (_build_od_calls, _check_build_opts, _host_planning_views,
                 _layer_params, _line_species_cols, _uniform_grid)

__all__ = ["make_od_sharded_lines_fn"]

_PAD = np.int32(-(2 ** 30))


def _pad_to(a, n, fill):
    pad = n - a.shape[0]
    if pad <= 0:
        return a[:n]
    return np.concatenate([a, np.full(pad, fill, dtype=a.dtype)])


def make_od_sharded_lines_fn(lines, iso, grid, atmos_class, n_shards: int,
                             wing_abs=0.0, wing_hw=50.0, max_groups: int = 8,
                             tile: int = 512, n_weideman: int = 16,
                             two_pass: bool = True, group_ratio: float = 1.6,
                             fast_rcp: bool = True):
    """Build the line-sharded per-shard OD function (the JAX builder's
    arguments and defaults; ``fast_rcp``: K1's fast reciprocal, as in
    :func:`~.od.make_od_fn`).

    Returns ``(local_fn, shard_data, padded_grid)``:

    * ``shard_data``: ``{"lines": {column: (n_shards, l_pad)}, "calls":
      [{"starts", "counts", "k_line", "frac0", "gather"}, ...]}``, each a
      tensor with a leading shard axis on the device of ``lines``
      (``gather`` maps a call's slots into the shard's line set);
    * ``local_fn(T, p_pa, pl, vmr, local, k_offset) -> (nLay, n_local)``,
      ``local`` shard s's slice of ``shard_data``
      (:func:`~.od.shard_slice`, on the device the state lies on) and
      ``k_offset = s * n_local``.
    """
    _check_build_opts(tile=tile)
    g0 = _uniform_grid(grid)
    align = 1024 * n_shards
    n_pad = -(-g0.n // align) * align
    g = UniformGrid(x0=g0.x0, dx=g0.dx, n=n_pad)
    n_local = n_pad // n_shards
    dev, dt = lines.sw.device, lines.sw.dtype

    lines_h, iso_h, states_h = _host_planning_views(lines, iso, atmos_class)
    nu0 = np.asarray(lines_h.nu0, dtype=np.float64)
    cols_global = _line_species_cols(lines_h, states_h[0].mol_ids)
    calls = _build_od_calls(lines_h, iso_h, states_h, g, wing_abs, wing_hw,
                            max_groups, tile, group_ratio, two_pass=two_pass)
    halo = max(c[2].max_wing for c in calls)

    # each shard's line set: in band plus halo, sorted, and one inert slot
    shard_lo = g.x0 + g.dx * n_local * np.arange(n_shards)
    shard_hi = shard_lo + g.dx * n_local
    s_beg = np.searchsorted(nu0, shard_lo - halo, side="left")
    s_end = np.searchsorted(nu0, shard_hi + halo, side="right")
    l_pad = int((s_end - s_beg).max()) + 1

    def stack_col(arr, fill):
        arr = np.asarray(arr)
        return np.stack([_pad_to(arr[b:e], l_pad, fill)
                         for b, e in zip(s_beg, s_end)])

    host = lines.host
    line_cols = {
        "nu0": stack_col(host["nu0"], 1.0e9),
        "sw": stack_col(host["sw"], 0.0),
        "elower": stack_col(host["elower"], 0.0),
        "gamma_air": stack_col(host["gamma_air"], 1e-4),
        "gamma_self": stack_col(host["gamma_self"], 1e-4),
        "n_air": stack_col(host["n_air"], 0.5),
        "delta_air": stack_col(host["delta_air"], 0.0),
        "sd_air": stack_col(host["sd_air"], 0.0),
        "iso_row": stack_col(host["iso_row"].astype(np.int32), np.int32(0)),
        "mol_id": stack_col(host["mol_id"].astype(np.int32), np.int32(0)),
        "species_col": stack_col(cols_global.astype(np.int32), np.int32(0)),
    }

    # each call's per-shard plans (the class's lines within the call's
    # halo, planned on the whole padded grid, restricted to the shard's
    # tiles) and the maps of its slots into the shard's line set
    call_meta, call_data = [], []
    for lay_idx, cls_idx, gplan, mode in calls:
        cls_idx = np.asarray(cls_idx)
        cls_nu0 = nu0[cls_idx]
        tile_c, block_c = gplan.tile, gplan.block
        nt_loc = n_local // tile_c
        per_shard = []
        nb_max, mb_max = 1, 1
        for s in range(n_shards):
            lo_i = np.searchsorted(cls_nu0, shard_lo[s] - gplan.max_wing,
                                   "left")
            hi_i = np.searchsorted(cls_nu0, shard_hi[s] + gplan.max_wing,
                                   "right")
            sub = cls_idx[lo_i:hi_i]
            if sub.size:
                p = plan_buckets(nu0[sub], g, gplan.max_wing, tile=tile_c,
                                 block=block_c)
                t0 = s * nt_loc
                starts = p.starts[t0:t0 + nt_loc]
                counts = p.counts[t0:t0 + nt_loc]
                k_line, frac0 = p.k_line.reshape(-1), p.frac0.reshape(-1)
                nb = p.n_blocks
            else:
                starts = np.zeros(nt_loc, np.int32)
                counts = np.zeros(nt_loc, np.int32)
                k_line = np.full(block_c, _PAD, np.int32)
                frac0 = np.zeros(block_c, np.float32)
                nb = 1
            idx_local = (sub - s_beg[s]).astype(np.int32)
            gather = _pad_to(idx_local, nb * block_c, np.int32(l_pad - 1))
            per_shard.append((starts, counts, k_line, frac0, gather, nb))
            nb_max = max(nb_max, nb)
            mb_max = max(mb_max, int(counts.max()) if counts.size else 0)
        S, C, K, F, G = [], [], [], [], []
        for starts, counts, k_line, frac0, gather, nb in per_shard:
            K.append(_pad_to(k_line, nb_max * block_c, _PAD))
            F.append(_pad_to(frac0, nb_max * block_c, np.float32(0.0)))
            G.append(_pad_to(gather, nb_max * block_c, np.int32(l_pad - 1)))
            S.append(np.minimum(starts, nb_max - 1))
            C.append(counts)
        call_meta.append((np.sort(np.asarray(lay_idx)), tile_c, block_c,
                          max(mb_max, 1), gplan.max_wing, mode))
        call_data.append(dict(starts=np.stack(S), counts=np.stack(C),
                              k_line=np.stack(K), frac0=np.stack(F),
                              gather=np.stack(G)))

    if dt == torch.float64:
        # a float64 run's line positions in float64, as device_plan's
        for d in call_data:
            nu_slot = np.take_along_axis(line_cols["nu0"], d["gather"],
                                         axis=1)
            u = (nu_slot - g.x0) / g.dx
            d["frac0"] = np.where(d["k_line"] == _PAD, 0.0, u - np.floor(u))

    t = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa
    f_cols = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
              "delta_air", "sd_air")
    shard_data = {
        "lines": {k: (t(v).to(dt) if k in f_cols else t(v))
                  for k, v in line_cols.items()},
        "calls": [{k: (t(v).to(dt) if k == "frac0" else t(v))
                   for k, v in d.items()} for d in call_data],
    }

    def local_fn(T, p_pa, pl, vmr, local, k_offset):
        # NumPy state columns join the shard's data in the store's dtype
        T, p_pa, pl, vmr = arrays_on(T, p_pa, pl, vmr, dtype=dt,
                                     device=local["lines"]["nu0"].device)
        dv = T.device
        lc = {k: v.reshape(-1) for k, v in local["lines"].items()}
        store = LineStore(**{k: lc[k] for k in f_cols},
                          iso_row=lc["iso_row"].long(),
                          mol_id=lc["mol_id"].long())
        prm = _layer_params(store, iso, T, p_pa, pl, vmr,
                            lc["species_col"].long(), wing_abs, wing_hw,
                            "voigt")
        out = torch.zeros((T.shape[0], n_local), dtype=prm.strength.dtype,
                          device=dv)
        for (lay, tile_c, block_c, mb, wmax, mode), d in zip(
                call_meta, local["calls"]):
            k_line = d["k_line"].reshape(-1)
            dplan = DevicePlan(
                tile=tile_c, block=block_c, n_tiles=n_local // tile_c,
                max_blocks=mb, dx=g.dx, n_out=n_local,
                starts=d["starts"].reshape(-1), counts=d["counts"].reshape(-1),
                k_line=k_line, frac0=d["frac0"].reshape(-1),
                line=d["gather"].reshape(-1),
                wcap=torch.full(k_line.shape, wmax, dtype=torch.float32,
                                device=dv))
            lay_t = torch.as_tensor(lay, dtype=torch.int32, device=dv)
            out.index_add_(0, lay_t, xsect_fused(
                dplan, lay_t, prm.shift0, prm.strength, prm.gamma_d,
                prm.gamma_0, prm.wing, None, mode, n_weideman,
                fast=fast_rcp, k_offset=k_offset))
        return out

    return local_fn, shard_data, g
