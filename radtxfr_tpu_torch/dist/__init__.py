"""Resumable ensemble checkpoints (counterpart of ``radtxfr_tpu/dist``;
the mesh, the sharded ensemble builders and ``host_gather`` are ROADMAP
M15)."""

from .checkpoint import (EnsembleCheckpoint, TiledCheckpoint,  # noqa: F401
                         run_batched, run_tiled)
