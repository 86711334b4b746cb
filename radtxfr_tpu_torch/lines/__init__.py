"""Line lists and partition sums (counterpart of ``radtxfr_tpu/lines``)."""

from .store import LineStore, IsoTables, from_arrays, parse_par  # noqa: F401
from .synthetic import synthetic_lines  # noqa: F401
from .tips import partition_sum, partition_sum_ratio  # noqa: F401
