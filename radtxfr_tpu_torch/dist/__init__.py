"""The (ensemble x spectrum) mesh, the sharded ensemble and Jacobian
builders, multi-process initialization and resumable checkpoints
(counterpart of ``radtxfr_tpu/dist``; ``tud_ensemble_pallas`` is
:func:`tud_ensemble_fused` here, and ``pallas_ensemble``
:mod:`.fused_ensemble`)."""

from .mesh import make_mesh, ENSEMBLE, SPECTRUM  # noqa: F401
from .ensemble import stack_states, tud_ensemble_sharded  # noqa: F401
from .checkpoint import (EnsembleCheckpoint, TiledCheckpoint,  # noqa: F401
                         host_gather, run_batched, run_tiled)
from .fused_ensemble import (make_tud_ensemble_fn,  # noqa: F401
                             tud_ensemble_fused)
