"""Sharded ensemble TUD by the reference engine (counterpart of
``radtxfr_tpu/dist/ensemble.py``).

The reference fans 24-atmosphere batches over a 6-process pool
(``Generate_LWIR_TUD.py:98-150``). Here the batch and the grid split over
an (ensemble x spectrum) :class:`~.mesh.Mesh`: each entry (e, s) computes
its members' TUD on its sub-band on its own device, the line list
replicated (every spectral shard evaluates its sub-band exactly). This is
the plain PyTorch path, layer by layer through
:func:`~..products.od.compute_od_layer`; the kernels' path is
:mod:`.fused_ensemble`. On a mesh over several processes each process
computes the entries it owns, and :func:`share_parts` hands every process
the others' (JAX's global array and ``host_gather``).
"""

from __future__ import annotations

import contextlib
import dataclasses

import torch

from ..atmos.continuum import continuum_od
from ..atmos.profile import AtmosphericState
from ..core.planck import planckian
from ..products.od import _line_species_cols, _lines_on, compute_od_layer
from ..products.tud import tud_from_od
from .mesh import ENSEMBLE, SPECTRUM

__all__ = ["stack_states", "tud_ensemble_sharded", "gather_shards",
           "share_parts", "shard_context"]


def stack_states(states) -> AtmosphericState:
    """Stack a list of :class:`AtmosphericState` into one batched state
    (a leading batch axis on every tensor)."""
    f = ("z0", "z1", "pl", "p", "T", "vmr")
    return AtmosphericState(**{k: torch.stack([getattr(s, k) for s in states])
                               for k in f}, mol_ids=states[0].mol_ids)


def member(batch: AtmosphericState, i: int, device) -> AtmosphericState:
    """Member ``i`` of a batched state, on ``device``."""
    return dataclasses.replace(batch, **{
        k: getattr(batch, k)[i].to(device)
        for k in ("z0", "z1", "pl", "p", "T", "vmr")})


def shard_context(device):
    """The context a mesh entry's work runs in: its device made current
    for a CUDA device (kernels launch on the current device's stream),
    nothing for the CPU."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def gather_shards(parts, out_device, n_members: int, n_x: int,
                  point_index=None):
    """Join the mesh's (tau, Lu, Ld) parts on ``out_device`` in the layout
    of JAX's ``out_specs`` (ENSEMBLE, SPECTRUM): ``parts[(e, s)]`` holds
    the members of ensemble slice e on spectral shard s, tau/Lu (m, n_local,
    nZs, nMu) and Ld (m, n_local). ``point_index`` (n_shards, n_local) puts
    a permuted shard's points at their global positions (the weighted
    partition); otherwise shard s holds the contiguous slice s."""
    tau = Lu = Ld = None
    for (e, s), (t, u, d) in parts.items():
        if tau is None:
            zs, mu = t.shape[2:]
            tau = torch.empty((n_members, n_x, zs, mu), dtype=t.dtype,
                              device=out_device)
            Lu = torch.empty_like(tau)
            Ld = torch.empty((n_members, n_x), dtype=d.dtype,
                             device=out_device)
        m, nl = t.shape[:2]
        rows = slice(e * m, (e + 1) * m)
        cols = (slice(s * nl, (s + 1) * nl) if point_index is None
                else torch.as_tensor(point_index[s], device=out_device))
        tau[rows, cols] = t.to(out_device)
        Lu[rows, cols] = u.to(out_device)
        Ld[rows, cols] = d.to(out_device)
    return tau, Lu, Ld


def share_parts(parts, mesh, rows=None) -> dict:
    """Every entry's part in every process: ``parts`` holds this process's
    entries (e, s) of the ensemble ``rows`` (default: all), each a tuple of
    tensors; on a mesh over several processes each entry's owner
    broadcasts its tensors through the group, entry by entry in mesh order,
    and the others receive them on the host. The bits are moved as they
    are: nothing is reduced across processes (line data are replicated and
    shards cover disjoint sub-bands). Every process of the group calls it
    with the same ``rows``; elsewhere ``parts`` is returned as it is."""
    if not mesh.spans_group:
        return parts
    import torch.distributed as dist

    rank = dist.get_rank()
    n_ens, n_spec = mesh.devices.shape
    out = {}
    for e in range(n_ens) if rows is None else rows:
        for s in range(n_spec):
            src = mesh.owner(e, s)
            if src == rank:
                host = [a.detach().cpu().contiguous() for a in parts[(e, s)]]
                head = [[(tuple(a.shape), a.dtype) for a in host]]
            else:
                head = [None]
            dist.broadcast_object_list(head, src=src)
            if src != rank:
                host = [torch.empty(shape, dtype=dt) for shape, dt in head[0]]
            for a in host:
                dist.broadcast(a, src=src)
            out[(e, s)] = parts[(e, s)] if src == rank else tuple(host)
    return out


def tud_ensemble_sharded(lines, iso, grid, batch: AtmosphericState,
                         altitudes, mesh, mu=1.0, n_angles: int = 30,
                         quadrature: str = "uniform", return_od: bool = False,
                         chunk: int = 512, continuum: str = "none",
                         continuum_factors=None):
    """TUD of a batch of atmospheres on an (ensemble x spectrum) mesh.

    ``batch`` carries a leading batch axis on every tensor (its size a
    multiple of the ensemble axis) and ``len(grid)`` must be a multiple of
    the spectrum axis. Returns (tau, Lu, Ld), (B, nX, nZs, nMu), (B, nX,
    nZs, nMu) and (B, nX), on the device of ``batch``. On a mesh over
    several processes, every process of the group calls it with the same
    inputs, computes its own entries and receives the whole.
    """
    grid = torch.as_tensor(grid)
    n_spec, n_ens = mesh.shape[SPECTRUM], mesh.shape[ENSEMBLE]
    n_x, n_b = grid.shape[0], batch.T.shape[0]
    if n_x % n_spec:
        raise ValueError(f"grid size {n_x} not divisible by spectrum axis "
                         f"{n_spec}")
    if n_b % n_ens:
        raise ValueError(f"batch {n_b} not divisible by ensemble axis "
                         f"{n_ens}")
    cols = _line_species_cols(lines.host_view(), batch.mol_ids)
    n_loc, m = n_x // n_spec, n_b // n_ens
    on = {}
    for dev in mesh.distinct():
        lines_d, iso_d = _lines_on(lines, iso, dev)
        on[dev] = (lines_d, iso_d,
                   torch.atleast_1d(torch.as_tensor(altitudes, device=dev)),
                   torch.atleast_1d(torch.as_tensor(mu, device=dev)))
    parts = {}
    for e, s in mesh.owned():
        dev = mesh.devices[e, s]
        lines_d, iso_d, alts, mu_d = on[dev]
        with shard_context(dev):
            x = grid[s * n_loc:(s + 1) * n_loc].to(dev)
            outs = []
            for i in range(e * m, (e + 1) * m):
                st = member(batch, i, dev)
                od = torch.stack([
                    compute_od_layer(lines_d, iso_d, x, T_l, p_l, pl_l,
                                     vmr_l, cols, chunk=chunk)
                    for T_l, p_l, pl_l, vmr_l in zip(st.T, st.p, st.pl,
                                                     st.vmr)])
                if continuum != "none":
                    od = od + continuum_od(
                        x, st, model=continuum,
                        continuum_factors=continuum_factors).to(od.dtype)
                B = planckian(x, st.T).transpose(0, 1).to(od.dtype)
                tud = tud_from_od(x, od, B, st.z0, alts,
                                  mu=mu_d.to(od.dtype), n_angles=n_angles,
                                  return_od=return_od, quadrature=quadrature)
                outs.append((tud.tau, tud.Lu, tud.Ld))
            parts[(e, s)] = tuple(torch.stack(a) for a in zip(*outs))
    return gather_shards(share_parts(parts, mesh), batch.T.device, n_b, n_x)
