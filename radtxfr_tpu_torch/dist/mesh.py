"""Device meshes for the (ensemble x spectrum) layout (counterpart of
``radtxfr_tpu/dist/mesh.py``).

The reference's only parallelism is a 6-process pool over atmospheres
(``Generate_LWIR_TUD.py:98-149``). The layout here is a 2-D logical mesh of
devices:

* ``ensemble`` — data-parallel over atmospheric states;
* ``spectrum`` — the fine wavenumber grid sharded over devices (line lists
  replicated, so each spectral shard computes its sub-band exactly).

JAX runs one SPMD program over its ``Mesh``, whose devices may belong to
several processes (``jax.devices()`` after ``jax.distributed.initialize``).
Here each process walks the mesh entries it owns and launches each shard's
work on its device (:mod:`.fused_ensemble`); the parts owned by other
processes of the :func:`~.init.init_multihost` group reach it through the
group (:func:`~.ensemble.share_parts`). A :class:`Mesh` may list one device
several times (a virtual mesh, e.g. ``[torch.device("cpu")] * 4`` in the
tests, or one card, also one card shared by two processes): its entries in
one process then run one after another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import arrays_on
from .init import group_layout

__all__ = ["Mesh", "make_mesh", "ENSEMBLE", "SPECTRUM", "pad_axis_to"]

ENSEMBLE = "ensemble"
SPECTRUM = "spectrum"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (n_ensemble, n_spectrum) array of :class:`torch.device` and, for
    a mesh over the group's processes, the rank that owns each entry
    (``processes``; None: a mesh of this process alone, every entry its
    own)."""

    devices: np.ndarray    # (n_ensemble, n_spectrum) object array
    axis_names: tuple = (ENSEMBLE, SPECTRUM)
    processes: np.ndarray | None = None   # (n_ensemble, n_spectrum) int

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def spans_group(self) -> bool:
        """Whether the entries are shared out over a group of several
        processes (and every process of it takes part in each run)."""
        return self.processes is not None and group_layout()[1] > 1

    def owner(self, e: int, s: int) -> int:
        """The rank of the process that computes entry (e, s)."""
        return (group_layout()[0] if self.processes is None
                else int(self.processes[e, s]))

    def owned(self) -> list:
        """This process's entries (e, s), in mesh order."""
        rank = group_layout()[0]
        n_e, n_s = self.devices.shape
        return [(e, s) for e in range(n_e) for s in range(n_s)
                if self.owner(e, s) == rank]

    def distinct(self) -> list:
        """The devices of this process's entries, each once, in mesh
        order."""
        out = []
        for e, s in self.owned():
            if self.devices[e, s] not in out:
                out.append(self.devices[e, s])
        return out

    def pairs(self) -> list:
        """The entries as (process, device) pairs in mesh order (what
        :func:`make_mesh` takes back as ``devices``)."""
        n_e, n_s = self.devices.shape
        return [(self.owner(e, s), self.devices[e, s])
                for e in range(n_e) for s in range(n_s)]


def _global_devices() -> list:
    """Every process's CUDA devices as (process, device) pairs, rank-major,
    each process's in order (``jax.devices()``'s layout); every process of
    the group must call it (the counts go through the group)."""
    import torch.distributed as dist

    counts = [None] * group_layout()[1]
    dist.all_gather_object(counts, torch.cuda.device_count())
    return [(r, torch.device("cuda", i))
            for r, n in enumerate(counts) for i in range(n)]


def make_mesh(n_ensemble: int, n_spectrum: int, devices=None) -> Mesh:
    """An (n_ensemble, n_spectrum) mesh over ``devices``.

    Without a process group (or in a group of one), ``None`` takes every
    visible CUDA device. In an :func:`~.init.init_multihost` group of
    several processes, ``None`` takes every process's CUDA devices, rank by
    rank (every process must call it: the counts go through the group), and
    each entry belongs to the process of its device. ``devices`` may also
    name ``(process, device)`` pairs (:meth:`Mesh.pairs`: the tests' CPU
    meshes over two processes, one card shared by two processes); plain
    devices are this process's own, a mesh that stays within it. Raises
    ``ValueError`` with too few devices or a process outside the group;
    never falls back to the CPU."""
    rank, world = group_layout()
    if devices is None:
        devices = (_global_devices() if world > 1 else
                   [torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())])
    n = n_ensemble * n_spectrum
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    devices = list(devices[:n])
    spans = any(isinstance(d, (tuple, list)) for d in devices)
    if spans and not all(isinstance(d, (tuple, list)) and len(d) == 2
                         for d in devices):
        raise ValueError("name every device of a mesh as a (process, "
                         "device) pair, or none")
    dev = np.empty(n, dtype=object)
    dev[:] = [torch.device(d[1] if spans else d) for d in devices]
    procs = None
    if spans:
        procs = np.asarray([int(d[0]) for d in devices], dtype=np.int64)
        bad = procs[(procs < 0) | (procs >= world)]
        if bad.size:
            raise ValueError(f"process {int(bad[0])} is outside the group "
                             f"of {world} process(es)")
        procs = procs.reshape(n_ensemble, n_spectrum)
    return Mesh(dev.reshape(n_ensemble, n_spectrum), processes=procs)


def pad_axis_to(x, multiple: int, axis: int = 0, fill=0.0, device=None):
    """Pad ``axis`` of the tensor ``x`` up to a multiple (for even
    sharding); a NumPy ``x`` goes to ``device`` (None: the card)."""
    x, = arrays_on(x, device=device, lead=True)
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=axis)
