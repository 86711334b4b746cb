"""Line-shape profiles, line parameters and the cross-section kernels
(counterpart of ``radtxfr_tpu/kernels``)."""

from .faddeeva import wofz_real, weideman_coeffs  # noqa: F401
from .profiles import voigt, lorentz, doppler  # noqa: F401
from .lineparams import LineParams, compute_line_params  # noqa: F401
from .xsect import xsect_from_params  # noqa: F401
