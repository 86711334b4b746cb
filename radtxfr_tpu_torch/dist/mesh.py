"""Device meshes for the (ensemble x spectrum) layout (counterpart of
``radtxfr_tpu/dist/mesh.py``).

The reference's only parallelism is a 6-process pool over atmospheres
(``Generate_LWIR_TUD.py:98-149``). The layout here is a 2-D logical mesh of
devices:

* ``ensemble`` — data-parallel over atmospheric states;
* ``spectrum`` — the fine wavenumber grid sharded over devices (line lists
  replicated, so each spectral shard computes its sub-band exactly).

JAX runs one SPMD program over its ``Mesh``; here one controller walks the
mesh's entries and launches each shard's work on its device
(:mod:`.fused_ensemble`). A :class:`Mesh` may list one device several times
(a virtual mesh, e.g. ``[torch.device("cpu")] * 4`` in the tests, or one
card): its entries then run one after another.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Mesh", "make_mesh", "ENSEMBLE", "SPECTRUM", "pad_axis_to"]

ENSEMBLE = "ensemble"
SPECTRUM = "spectrum"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """An (n_ensemble, n_spectrum) array of :class:`torch.device`."""

    devices: np.ndarray    # (n_ensemble, n_spectrum) object array
    axis_names: tuple = (ENSEMBLE, SPECTRUM)

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    def distinct(self) -> list:
        """The mesh's devices, each once, in mesh order."""
        out = []
        for d in self.devices.ravel():
            if d not in out:
                out.append(d)
        return out


def make_mesh(n_ensemble: int, n_spectrum: int, devices=None) -> Mesh:
    """An (n_ensemble, n_spectrum) mesh over ``devices`` (None: every
    visible CUDA device). Raises ``ValueError`` with too few devices; never
    falls back to the CPU."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    n = n_ensemble * n_spectrum
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    dev = np.empty(n, dtype=object)
    dev[:] = [torch.device(d) for d in devices[:n]]
    return Mesh(dev.reshape(n_ensemble, n_spectrum))


def pad_axis_to(x, multiple: int, axis: int = 0, fill=0.0):
    """Pad ``axis`` of the tensor ``x`` up to a multiple (for even
    sharding)."""
    n = x.shape[axis]
    pad = (-n) % multiple
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device)], dim=axis)
