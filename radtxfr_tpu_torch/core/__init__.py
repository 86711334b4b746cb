"""Core constants, the Planck function and grid helpers (counterpart of
``radtxfr_tpu/core``; its ``brightness_temperature``, ``bt2l``,
``make_spectral_axis`` and ``reshape`` are not ported yet)."""

from .constants import *  # noqa: F401,F403
from .planck import planckian  # noqa: F401
from .grid import arange_drift_free  # noqa: F401
