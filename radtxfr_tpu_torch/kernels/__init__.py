"""Line-shape profiles, line parameters and the cross-section kernels
(counterpart of ``radtxfr_tpu/kernels``)."""

from .faddeeva import wofz_real, weideman_coeffs  # noqa: F401
from .profiles import voigt, lorentz, doppler  # noqa: F401
from .htp import (  # noqa: F401
    pcqsdhc, profile_ht, profile_sdvoigt, profile_sdrautian, profile_rautian,
)
from .lineparams import LineParams, compute_line_params  # noqa: F401
from .xsect import xsect_from_params  # noqa: F401
from .ht_driver import xsect_ht  # noqa: F401
from .spectra import (  # noqa: F401
    transmittance_spectrum, absorption_spectrum, radiance_spectrum,
    convolve_spectrum,
)
