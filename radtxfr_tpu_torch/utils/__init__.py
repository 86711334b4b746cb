"""Observability, retries, the kernel build cache, help and precision
guards (counterpart of ``radtxfr_tpu/utils``)."""

from .profiling import (PhaseTimer, device_sync, trace, span,  # noqa: F401
                        MetricsLog)
from .retry import retry  # noqa: F401
from .help import get_help, api_index  # noqa: F401
from .cache import enable_persistent_cache  # noqa: F401
from .precision import f32_matmuls  # noqa: F401
