"""Deterministic, resumable ensemble checkpointing (counterpart of
``radtxfr_tpu/dist/checkpoint.py``).

The reference re-saves its whole shared-memory arrays to one ``.npz`` after
every 24-atmosphere batch and has no code path that reads it back to skip
completed work (``Generate_LWIR_TUD.py:150``). Here a run over an ensemble
is split into a deterministic batch plan; each completed batch is persisted
as its own ``.npz``, written under a unique temporary name and moved into
place with ``os.replace``, so a file under its final name is always whole.
Completion is read from the batch files themselves (concurrent writers on
shared storage cannot race on manifest state), and a restarted job
recomputes only the missing batches. The JSON manifest holds only the
immutable plan (sizes and meta) for restart validation. Host NumPy only:
the files and the manifest are those of the JAX package, which reads a
directory written here and the reverse. :func:`host_gather` joins the
pieces of a ``torch.distributed`` group's processes on the host.
"""

from __future__ import annotations

import json
import os
import re
import uuid

import numpy as np

from .. import as_numpy

__all__ = ["EnsembleCheckpoint", "run_batched", "TiledCheckpoint",
           "run_tiled", "host_gather"]


class EnsembleCheckpoint:
    """Directory of per-batch ``batch_%06d.npz`` files and a JSON
    manifest."""

    def __init__(self, directory: str, n_items: int, batch_size: int,
                 meta: dict | None = None):
        self.directory = directory
        self.n_items = int(n_items)
        self.batch_size = int(batch_size)
        self.n_batches = -(-self.n_items // self.batch_size)
        os.makedirs(directory, exist_ok=True)
        self._manifest_path = os.path.join(directory, "manifest.json")
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                m = json.load(f)
            if (m["n_items"], m["batch_size"]) != (self.n_items,
                                                   self.batch_size):
                raise ValueError(
                    f"checkpoint at {directory} was created for "
                    f"n_items={m['n_items']}, batch_size={m['batch_size']}")
            self._manifest = m
        else:
            self._manifest = {"n_items": self.n_items,
                              "batch_size": self.batch_size,
                              "meta": meta or {}}
            self._flush()

    def _flush(self):
        # a unique temporary name per writer: several processes may flush
        # the same manifest at once, and a shared temporary path would
        # interleave their writes
        tmp = f"{self._manifest_path}.tmp.{uuid.uuid4().hex}"
        with open(tmp, "w") as f:
            json.dump(self._manifest, f)
        os.replace(tmp, self._manifest_path)

    def batch_indices(self, b: int) -> np.ndarray:
        lo = b * self.batch_size
        return np.arange(lo, min(lo + self.batch_size, self.n_items))

    @property
    def completed(self) -> set[int]:
        """The batches whose file is in place (never the manifest)."""
        pat = re.compile(r"^batch_(\d{6})\.npz$")
        return {int(m.group(1)) for name in os.listdir(self.directory)
                if (m := pat.match(name))}

    @property
    def pending(self) -> list[int]:
        done = self.completed
        return [b for b in range(self.n_batches) if b not in done]

    def _batch_path(self, b: int) -> str:
        return os.path.join(self.directory, f"batch_{b:06d}.npz")

    def write_batch(self, b: int, arrays: dict) -> None:
        tmp = f"{self._batch_path(b)}.tmp.{uuid.uuid4().hex}.npz"
        np.savez(tmp, **{k: as_numpy(v) for k, v in arrays.items()})
        os.replace(tmp, self._batch_path(b))

    def read_batch(self, b: int) -> dict:
        with np.load(self._batch_path(b)) as f:
            return {k: f[k].copy() for k in f.files}

    def gather(self) -> dict:
        """All batches concatenated along axis 0 in index order."""
        if self.pending:
            raise RuntimeError(f"batches incomplete: {self.pending}")
        parts = [self.read_batch(b) for b in range(self.n_batches)]
        if not parts:
            return {}
        return {k: np.concatenate([p[k] for p in parts], axis=0)
                for k in parts[0]}


class TiledCheckpoint:
    """(ensemble batch x spectral shard) tiles, ``tile_%06d_%03d.npz``, for
    jobs that split the spectrum: each writer persists the tiles it owns,
    and completion is the set of tile files present, so restarts on any
    number of writers skip every completed tile."""

    def __init__(self, directory: str, n_items: int, batch_size: int,
                 n_shards: int, meta: dict | None = None):
        self.directory = directory
        self.n_items = int(n_items)
        self.batch_size = int(batch_size)
        self.n_shards = int(n_shards)
        self.n_batches = -(-self.n_items // self.batch_size)
        os.makedirs(directory, exist_ok=True)
        self._manifest_path = os.path.join(directory, "manifest.json")
        key = {"n_items": self.n_items, "batch_size": self.batch_size,
               "n_shards": self.n_shards}
        if os.path.exists(self._manifest_path):
            with open(self._manifest_path) as f:
                m = json.load(f)
            if {k: m[k] for k in key} != key:
                raise ValueError(
                    f"checkpoint at {directory} was created for {m}")
            self._manifest = m
        else:
            self._manifest = dict(key, meta=meta or {})
            self._flush()

    _flush = EnsembleCheckpoint._flush
    batch_indices = EnsembleCheckpoint.batch_indices

    @property
    def completed(self) -> set[tuple[int, int]]:
        pat = re.compile(r"^tile_(\d{6})_(\d{3})\.npz$")
        return {(int(m.group(1)), int(m.group(2)))
                for name in os.listdir(self.directory)
                if (m := pat.match(name))}

    @property
    def pending(self) -> list[tuple[int, int]]:
        done = self.completed
        return [(b, s) for b in range(self.n_batches)
                for s in range(self.n_shards) if (b, s) not in done]

    def _tile_path(self, b: int, s: int) -> str:
        return os.path.join(self.directory, f"tile_{b:06d}_{s:03d}.npz")

    def write_tile(self, b: int, s: int, arrays: dict) -> None:
        tmp = f"{self._tile_path(b, s)}.tmp.{uuid.uuid4().hex}.npz"
        np.savez(tmp, **{k: as_numpy(v) for k, v in arrays.items()})
        os.replace(tmp, self._tile_path(b, s))

    def read_tile(self, b: int, s: int) -> dict:
        with np.load(self._tile_path(b, s)) as f:
            return {k: f[k].copy() for k in f.files}

    def gather(self, shard_axes: dict | int = -1) -> dict:
        """All tiles: shards concatenated along ``shard_axes`` (an int for
        every key, or one per key; ``None`` takes shard 0 of a replicated
        key), then batches along axis 0."""
        if self.pending:
            raise RuntimeError(f"tiles incomplete: {self.pending}")
        rows = []
        for b in range(self.n_batches):
            tiles = [self.read_tile(b, s) for s in range(self.n_shards)]
            row = {}
            for k in tiles[0]:
                ax = (shard_axes.get(k, -1) if isinstance(shard_axes, dict)
                      else shard_axes)
                row[k] = (tiles[0][k] if ax is None else
                          np.concatenate([t[k] for t in tiles], axis=ax))
            rows.append(row)
        return {k: np.concatenate([r[k] for r in rows], axis=0)
                for k in rows[0]}


def run_tiled(ckpt: TiledCheckpoint, compute_tile, log=print,
              shard_axes: dict | int = -1,
              owned_shards=None) -> dict | None:
    """Run ``compute_tile(indices, shard) -> dict`` over the pending tiles
    of ``owned_shards`` (default: all) and gather; None while tiles of
    other writers are missing. Several processes writing one directory
    each run their own shards, then meet at a barrier (e.g.
    ``torch.distributed.barrier()``) and call :meth:`TiledCheckpoint.gather`
    (``tests/test_torch_dist_multiprocess.py``)."""
    owned = set(range(ckpt.n_shards) if owned_shards is None
                else owned_shards)
    for b, s in ckpt.pending:
        if s not in owned:
            continue
        out = compute_tile(ckpt.batch_indices(b), s)
        ckpt.write_tile(b, s, out)
        if log:
            log(f"checkpoint: tile (batch {b + 1}/{ckpt.n_batches}, "
                f"shard {s}) done")
    return None if ckpt.pending else ckpt.gather(shard_axes=shard_axes)


def host_gather(arr):
    """``arr`` as a host ndarray: a tensor held in one process as it is
    (copied to the host), and, in a ``torch.distributed`` group of several
    processes, every process's piece all-gathered and joined along the
    leading axis, so each process receives the whole (the counterpart of
    ``process_allgather(..., tiled=True)``; every process calls it with
    pieces of one shape). The group is :func:`~.init.init_multihost`'s
    gloo group, which carries host tensors."""
    import torch
    import torch.distributed as dist

    t = torch.as_tensor(arr).detach()
    if not (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1):
        return t.cpu().numpy()
    t = t.cpu().contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, t)
    return torch.cat(parts).numpy()


def run_batched(ckpt: EnsembleCheckpoint, compute_batch, log=print,
                async_io: bool = False) -> dict:
    """Run ``compute_batch(indices) -> dict`` over the pending batches,
    persist each, and gather; a restart skips the completed batches.

    With ``async_io=True`` each batch's ``.npz`` write overlaps the next
    batch's compute on one writer thread: at most one write in flight, in
    batch order, so a crash loses at most the batch being written.
    """
    def write(b, idx, out):
        ckpt.write_batch(b, out)
        if log:
            log(f"checkpoint: batch {b + 1}/{ckpt.n_batches} "
                f"({idx[0]}..{idx[-1]}) done")

    if not async_io:
        for b in ckpt.pending:
            idx = ckpt.batch_indices(b)
            write(b, idx, compute_batch(idx))
        return ckpt.gather()

    from concurrent.futures import ThreadPoolExecutor

    with ThreadPoolExecutor(max_workers=1) as ex:
        pending_write = None
        for b in ckpt.pending:
            idx = ckpt.batch_indices(b)
            out = compute_batch(idx)
            if pending_write is not None:
                pending_write.result()
            pending_write = ex.submit(write, b, idx, out)
        if pending_write is not None:
            pending_write.result()
    return ckpt.gather()
