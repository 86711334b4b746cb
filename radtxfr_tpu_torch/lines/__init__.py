"""Line lists and partition sums (counterpart of ``radtxfr_tpu/lines``)."""

from .store import LineStore, IsoTables, from_arrays, parse_par  # noqa: F401
from .synthetic import synthetic_lines, to_hapi_cache  # noqa: F401
from .tips import partition_sum, partition_sum_ratio  # noqa: F401
from .query import (  # noqa: F401
    select, sort, evaluate, filter_mask, group, extract_columns, stick_xy,
)
from .hapi_db import HapiDatabase, load_table, save_table, write_par  # noqa: F401
