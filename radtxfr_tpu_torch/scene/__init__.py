"""Scene synthesis: emissivity databases, HSI cubes and the generative
atmosphere model (counterpart of ``radtxfr_tpu/scene``)."""

from .emissivity import EmissivityDB, synthetic_db  # noqa: F401
from .hsi import hsi_generate  # noqa: F401
from . import generative  # noqa: F401
from . import emis_features  # noqa: F401
