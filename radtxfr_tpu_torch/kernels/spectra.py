"""Spectra from absorption coefficients and instrument slit convolution
(counterpart of ``radtxfr_tpu/kernels/spectra.py``).

hapi's spectrum calculus (``misc/hapi.py:11582-11900``):

* Beer-Lambert transmittance exp(-k l), absorption 1 - exp(-k l)
  (``:11582-11613``), single-temperature radiance (1 - e^{-k l}) B(nu, T)
  in W/sr/cm^2/cm^-1 with the CGS constants (``:11644-11680``);
* :func:`convolve_spectrum`, the slit convolution with normalization and
  edge trim (``convolveSpectrum``, ``:11826-11900``), with the reference's
  seven slit shapes (``SLIT_*``, ``:11742-11823``).

The slits are NumPy functions of the host axis, as there; the spectra are
tensors on the device of the coefficient (a tensor's, else the card).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import arrays_on, as_numpy, as_tensor_on
from ..core.constants import C_LIGHT_CGS, H_PLANCK_CGS, K_BOLTZMANN_CGS
from ..core.grid import arange_drift_free

__all__ = [
    "transmittance_spectrum",
    "absorption_spectrum",
    "radiance_spectrum",
    "convolve_spectrum",
    "HAPI_SLITS",
]


# --- hapi slit functions, exact semantics (misc/hapi.py:11742-11823) --------

def _slit_rectangular(x, g):
    return np.where(np.abs(x) <= g / 2.0, 1.0 / g, 0.0)


def _slit_triangular(x, g):
    return np.where(np.abs(x) <= g, (1.0 - np.abs(x) / g) / g, 0.0)


def _slit_gaussian(x, g):
    h = g / 2.0
    return (np.sqrt(np.log(2.0)) / (np.sqrt(np.pi) * h)
            * np.exp(-np.log(2.0) * (x / h) ** 2))


def _slit_dispersion(x, g):
    h = g / 2.0
    return h / np.pi / (x**2 + h**2)


def _slit_cosinus(x, g):
    return (np.cos(np.pi / g * x) + 1.0) / (2.0 * g)


def _slit_diffraction(x, g):
    y = np.ones_like(x)
    nz = x != 0
    xs = np.pi / g * x[nz]
    y[nz] = (np.sin(xs) ** 2 / xs**2) / g
    return y


def _slit_michelson(x, g):
    y = np.ones_like(x)
    nz = x != 0
    xs = 2.0 * np.pi / g * x[nz]
    y[nz] = 2.0 / g * np.sin(xs) / xs
    return y


HAPI_SLITS = {
    "rectangular": _slit_rectangular,
    "triangular": _slit_triangular,
    "gaussian": _slit_gaussian,
    "dispersion": _slit_dispersion,
    "cosinus": _slit_cosinus,
    "diffraction": _slit_diffraction,
    "michelson": _slit_michelson,
}


def transmittance_spectrum(omegas, abscoef, path_cm: float = 100.0,
                           device=None):
    """exp(-k l); the default 100 cm environment length of the reference.
    A NumPy ``abscoef`` goes to ``device`` (None: the card)."""
    abscoef, = arrays_on(abscoef, device=device, lead=True)
    return torch.exp(-abscoef * path_cm)


def absorption_spectrum(omegas, abscoef, path_cm: float = 100.0,
                        device=None):
    """1 - exp(-k l)."""
    abscoef, = arrays_on(abscoef, device=device, lead=True)
    return 1.0 - torch.exp(-abscoef * path_cm)


def radiance_spectrum(omegas, abscoef, path_cm: float = 100.0,
                      T: float = 296.0, device=None):
    """Single-temperature emission spectrum [W/sr/cm^2/cm^-1]
    (``misc/hapi.py:11644-11680``), on the coefficient's device."""
    k, omegas = arrays_on(abscoef, omegas, device=device, lead=True)
    omegas = as_tensor_on(omegas, k.device)
    LBBTw = (
        2.0 * H_PLANCK_CGS * C_LIGHT_CGS**2 * omegas**3
        / (torch.exp(H_PLANCK_CGS * C_LIGHT_CGS * omegas
                     / (K_BOLTZMANN_CGS * T)) - 1.0)
        * 1.0e-7
    )
    return (1.0 - torch.exp(-k * path_cm)) * LBBTw


def convolve_1d(y: torch.Tensor, w: np.ndarray,
                mode: str = "same") -> torch.Tensor:
    """``np.convolve(y, w, mode)`` for ``mode`` 'full' or 'same', on
    ``y``'s device in its dtype: the full convolution (``conv1d``
    correlates, so the slit is flipped), for 'same' cut to
    max(len(y), len(w)) points from (min(len(y), len(w)) - 1) // 2, NumPy's
    centring, for odd and even slit lengths alike."""
    n, m = y.shape[0], len(w)
    wt = torch.as_tensor(w[::-1].copy(), dtype=y.dtype, device=y.device)
    full = torch.nn.functional.conv1d(y[None, None], wt[None, None],
                                      padding=m - 1)[0, 0]
    if mode == "full":
        return full
    if mode != "same":
        raise ValueError(f"mode must be 'same' or 'full', got {mode!r}")
    lo = (min(n, m) - 1) // 2
    return full[lo:lo + max(n, m)]


def convolve_spectrum(omega, cross_section, resolution: float = 0.1,
                      af_wing: float = 10.0, slit="rectangular",
                      device=None):
    """Low-resolution convolution with a slit function.

    Exact ``convolveSpectrum`` semantics (``misc/hapi.py:11826-11866``):
    slit sampled on the drift-free grid over +-``af_wing`` at the data
    step, normalized by sum*step, 'same'-mode convolution scaled by step,
    trimmed by the slit half-length. ``slit`` is a name from
    :data:`HAPI_SLITS` or a callable (x, g) -> weights. Returns
    (omega_trim NumPy, y_trim tensor on the spectrum's device, i1, i2,
    slit_vals NumPy); a NumPy spectrum goes to ``device`` (None: the
    card).
    """
    omega = as_numpy(omega).astype(np.float64)
    y, = arrays_on(cross_section, device=device, lead=True)
    step = float(omega[1] - omega[0])
    if step >= resolution:
        raise ValueError("step must be less than resolution")
    x = arange_drift_free(-af_wing, af_wing + step, step)
    fn = HAPI_SLITS[slit] if isinstance(slit, str) else slit
    w = fn(x, resolution)
    w = w / (w.sum() * step)
    y_conv = convolve_1d(y, w) * step
    left = len(x) // 2
    right = len(omega) - len(x) // 2
    return (omega[left:right], y_conv[left:right], left, right, w)
