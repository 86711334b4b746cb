"""File formats (counterpart of ``radtxfr_tpu/io``): HDF5, AFIT MBI, AFIT
cross-section binaries, LBLRTM tapes; host NumPy."""

from .h5 import Var, write_h5, read_h5, gen_indices  # noqa: F401
from .mbi import mbi_export, mbi_read  # noqa: F401
from .afit_xs import xs_write, xs_read, xs_default_filename  # noqa: F401
from .lblrtm import (read_tape12, write_tape12, write_tape5,  # noqa: F401
                     read_tape3, write_tape3, tape3_to_linestore)
