"""Core constants, Planck physics, grids and reshapes (counterpart of
``radtxfr_tpu/core``)."""

from .constants import *  # noqa: F401,F403
from .planck import planckian, brightness_temperature, bt2l  # noqa: F401
from .grid import make_spectral_axis, arange_drift_free  # noqa: F401
from .reshape import rs1d, rs2d, rsnd  # noqa: F401
