"""Atmospheric states and continua (counterpart of ``radtxfr_tpu/atmos``)."""

from .profile import AtmosphericState, std_atmosphere, STD_ATMOS_MOL_IDS  # noqa: F401
from .continuum import continuum_od, register_continuum  # noqa: F401
