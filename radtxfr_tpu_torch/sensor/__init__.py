"""Spectral resolution reduction (counterpart of ``radtxfr_tpu/sensor``)."""

from .resolution import (smooth, reduce_resolution,  # noqa: F401
                         reduce_operator, ReduceOperator)
