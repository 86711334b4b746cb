"""Instrument line shapes and spectral resolution reduction (counterpart of
``radtxfr_tpu/sensor``)."""

from .ils import ils_mako, ils_matrix, apply_ils, mako_wavelengths_um  # noqa: F401
from .resolution import (smooth, reduce_resolution,  # noqa: F401
                         reduce_operator, ReduceOperator)
