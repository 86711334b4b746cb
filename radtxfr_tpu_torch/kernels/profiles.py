"""Normalized line-shape profiles, Voigt / Lorentz / Doppler (counterpart
of ``radtxfr_tpu/kernels/profiles.py``).

* Voigt: hapi routes PROFILE_VOIGT through the Hartmann-Tran profile with
  zeroed HT parameters (``misc/hapi.py:10131-10140``), which collapses to
  K(x, y) = sqrt(ln2/pi)/gamma_D Re w(x + iy),
  x = sqrt(ln2)(nu - nu0)/gamma_D, y = sqrt(ln2) gamma_0/gamma_D.
* Lorentz: gamma0 / (pi (gamma0^2 + dnu^2)) (``misc/hapi.py:10142``).
* Doppler: hapi's literal truncated constants (``cSqrtLn2divSqrtPi``,
  ``cLn2``, ``misc/hapi.py:88-90,10160``).

Elementwise over ``dnu`` (centred, shift applied by the caller), broadcast
against per-line parameters; NumPy arguments join a tensor argument's
device, else ``device`` (None: the card).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import arrays_on
from ..core.constants import LN2, SQRT_LN2_DIV_SQRT_PI
from .faddeeva import wofz_real

__all__ = ["voigt", "lorentz", "doppler"]

_SQRT_LN2 = np.sqrt(np.log(2.0))
_INV_SQRT_PI = 1.0 / np.sqrt(np.pi)


def voigt(dnu, gamma_d, gamma_0, n_weideman: int = 24, device=None):
    """Voigt profile value [cm] at ``dnu = nu - (nu0 + shift0)``."""
    dnu, gamma_d, gamma_0 = arrays_on(dnu, gamma_d, gamma_0, device=device)
    cte = _SQRT_LN2 / gamma_d
    wr, _ = wofz_real(dnu * cte, gamma_0 * cte, n_weideman)
    return cte * _INV_SQRT_PI * wr


def lorentz(dnu, gamma_0, device=None):
    """Lorentz profile value [cm]."""
    dnu, gamma_0 = arrays_on(dnu, gamma_0, device=device)
    return gamma_0 / (np.pi * (gamma_0 * gamma_0 + dnu * dnu))


def doppler(dnu, gamma_d, device=None):
    """Doppler (Gaussian) profile value [cm], hapi constants."""
    dnu, gamma_d = arrays_on(dnu, gamma_d, device=device)
    return (SQRT_LN2_DIV_SQRT_PI * torch.exp(-LN2 * (dnu / gamma_d) ** 2)
            / gamma_d)
