"""Multi-process runtime initialization (counterpart of
``radtxfr_tpu/dist/init.py``).

The reference has no distributed backend (a single-host ``multiprocessing``
pool, ``Generate_LWIR_TUD.py:98-149``). Processes here join one
``torch.distributed`` group: call :func:`init_multihost` once per process;
the JAX coordinator address, process count and process id map to a
``tcp://`` init method, the world size and the rank. As JAX's meshes
after ``jax.distributed.initialize``, a mesh then spans every process's
cards (:func:`~.mesh.make_mesh`): each process computes the entries it owns,
and the group carries the other entries' parts to it
(:func:`~.ensemble.share_parts`) and the host-side gathers
(:func:`~.checkpoint.host_gather`). The backend is gloo, which moves host
tensors: NCCL refuses two ranks on one card, and the parts are gathered on
the host anyway.
"""

from __future__ import annotations

import os

import torch

__all__ = ["init_multihost", "runtime_info", "group_layout"]


def init_multihost(coordinator_address: str | None = None,
                   num_processes: int | None = None,
                   process_id: int | None = None) -> None:
    """Join this process to the group (``torch.distributed``).

    Arguments default to JAX's environment variables
    (``JAX_COORDINATOR_ADDRESS`` as ``host:port``, ``JAX_NUM_PROCESSES``,
    ``JAX_PROCESS_ID``); without a coordinator the init method is
    ``env://`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``). The backend is gloo, which carries the host tensors that
    :func:`~.checkpoint.host_gather` gathers.
    """
    import torch.distributed as dist

    addr = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    kwargs = {}
    if num_processes or os.environ.get("JAX_NUM_PROCESSES"):
        kwargs["world_size"] = int(num_processes
                                   or os.environ["JAX_NUM_PROCESSES"])
    if process_id is not None or os.environ.get("JAX_PROCESS_ID"):
        kwargs["rank"] = int(process_id if process_id is not None
                             else os.environ["JAX_PROCESS_ID"])
    init = f"tcp://{addr}" if addr else "env://"
    dist.init_process_group("gloo", init_method=init, **kwargs)


def group_layout() -> tuple:
    """(this process's rank, the group's size): (0, 1) without a group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def runtime_info() -> dict:
    """Process/device layout summary for logs."""
    import torch.distributed as dist

    rank, world = group_layout()
    n_local = torch.cuda.device_count()
    counts = [n_local]
    if dist.is_available() and dist.is_initialized():
        counts = [None] * world
        dist.all_gather_object(counts, n_local)
    return {
        "process_index": rank,
        "process_count": world,
        "local_devices": n_local,
        "global_devices": int(sum(counts)),
        "backend": "cuda" if n_local else "cpu",
    }
