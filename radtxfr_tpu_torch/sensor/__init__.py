"""Spectral resolution reduction (counterpart of ``radtxfr_tpu/sensor``)."""

from .resolution import reduce_operator, ReduceOperator  # noqa: F401
