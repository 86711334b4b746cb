"""HDF5 and AFIT cross-section files (counterpart of ``radtxfr_tpu/io``)."""

from .h5 import Var, write_h5, read_h5, gen_indices  # noqa: F401
from .afit_xs import xs_write, xs_read, xs_default_filename  # noqa: F401
