"""Where the CUDA kernels are built and loaded from (counterpart of
``radtxfr_tpu/utils/cache.py``, JAX's persistent compilation cache).

Every ``nvcc`` build of ``csrc/`` (and the ``.par`` parser's ``g++``
build) is kept on disk under a name hashed from its sources and flags
(:mod:`radtxfr_tpu_torch._build`), so every process after the first loads
the libraries instead of compiling them: the port's persistent cache is
always on. This names its directory.
"""

from __future__ import annotations

import os

__all__ = ["enable_persistent_cache"]


def enable_persistent_cache(directory: str | None = None,
                            min_compile_secs: float = 1.0) -> str:
    """Point the kernel builds at ``directory`` and return it.

    ``directory`` defaults to ``$RADTXFR_CACHE_DIR``, else
    ``radtxfr_tpu_torch/_build/`` (the default build directory). Call
    before the first kernel launch in the process: libraries already
    loaded stay loaded. ``min_compile_secs`` is accepted for the JAX
    signature and has no effect: every build is cached, whatever it took.
    """
    from .. import _build
    from ..lines import native_parser

    directory = (directory or os.environ.get("RADTXFR_CACHE_DIR")
                 or _build.DEFAULT_BUILD_DIR)
    directory = os.path.abspath(directory)
    os.makedirs(directory, exist_ok=True)
    _build.BUILD_DIR = directory
    native_parser.BUILD_DIR = directory
    return directory
