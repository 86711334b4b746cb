"""Voigt line shape (counterpart of ``radtxfr_tpu/kernels/profiles.py``).

hapi routes PROFILE_VOIGT through the Hartmann-Tran profile with zeroed HT
parameters (``misc/hapi.py:10131-10140``), which collapses to
K(x, y) = sqrt(ln2/pi)/gamma_D Re w(x + iy), x = sqrt(ln2)(nu - nu0)/gamma_D,
y = sqrt(ln2) gamma_0/gamma_D.
"""

from __future__ import annotations

import numpy as np

from .faddeeva import wofz_real

__all__ = ["voigt"]

_SQRT_LN2 = np.sqrt(np.log(2.0))
_INV_SQRT_PI = 1.0 / np.sqrt(np.pi)


def voigt(dnu, gamma_d, gamma_0, n_weideman: int = 24):
    """Voigt profile value [cm] at ``dnu = nu - (nu0 + shift0)``."""
    cte = _SQRT_LN2 / gamma_d
    wr, _ = wofz_real(dnu * cte, gamma_0 * cte, n_weideman)
    return cte * _INV_SQRT_PI * wr
