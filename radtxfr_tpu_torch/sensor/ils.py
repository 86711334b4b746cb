"""Instrument line shape (ILS) convolution as a precomputed weight matrix
(counterpart of ``radtxfr_tpu/sensor/ils.py``).

The reference builds a dense (nX_hi, n_chan) triangle-lineshape weight
array inside every ``ILS_MAKO`` call (``radiative_transfer.py:1072-1263``).
Here the matrix is built once on the host in float64 (the spectral axes are
static), column-normalized, and applied on the device as one dense product
(TF32 off, ``radtxfr_tpu_torch/__init__.py``) that batches over any number
of spectra.

The MAKO 128-channel wavelength axis is the packaged table
``radtxfr_tpu/data/mako_channels_um.npy`` (read by path). The hapi slit
functions (``misc/hapi.py:11742-11823``) are the window generators of
:func:`ils_matrix`.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from .. import DATA_DIR, as_numpy, resolve_device

__all__ = [
    "ils_mako_simple",
    "mako_wavelengths_um",
    "mako_axis_wn",
    "ils_matrix",
    "apply_ils",
    "ils_mako",
    "SLIT_SHAPES",
]


@functools.lru_cache(maxsize=1)
def _mako_table() -> np.ndarray:
    return np.load(os.path.join(DATA_DIR, "mako_channels_um.npy"))


def mako_wavelengths_um() -> np.ndarray:
    """The 128 MAKO channel centres [µm] (radiative_transfer.py:1092-1223)."""
    return _mako_table().copy()


def mako_axis_wn(X, res_factor=None) -> np.ndarray:
    """MAKO output axis in wavenumbers, trimmed in-band
    (``radiative_transfer.py:1226-1233``): optional upsampling by linear
    interpolation in channel index, µm -> cm^-1, sort, trim to the open
    interval (X.min(), X.max())."""
    X = as_numpy(X)
    x_um = _mako_table()
    if res_factor is not None:
        t0 = np.linspace(0.0, 1.0, x_um.size)
        t1 = np.linspace(0.0, 1.0, int(x_um.size * res_factor))
        x_um = np.interp(t1, t0, x_um)
    x_wn = np.sort(10000.0 / x_um)
    return x_wn[(x_wn > X.min()) & (x_wn < X.max())]


# --- slit-function windows (hapi misc/hapi.py:11742-11823 semantics) --------

def _tri(d, s):
    return np.maximum(1.0 - np.abs(d) / s, 0.0)


def _gauss(d, s):
    return np.exp(-0.5 * (d / s) ** 2) / (s * np.sqrt(2.0 * np.pi))


def _rect(d, s):
    return (np.abs(d) <= s).astype(np.float64)


def _lorentz_slit(d, s):
    return s / (np.pi * (d * d + s * s))


def _cosine(d, s):
    w = np.cos(np.pi / 2.0 * d / s)
    return np.where(np.abs(d) <= s, np.maximum(w, 0.0), 0.0)


def _diffraction(d, s):
    x = np.pi * d / s
    out = np.ones_like(d)
    nz = x != 0
    out[nz] = (np.sin(x[nz]) / x[nz]) ** 2
    return out


def _michelson(d, s):
    # elementwise over the (nX, n_chan) grid (the JAX package's masked
    # assignment of the (1, n_chan) widths raises inside ils_matrix)
    x = 2.0 * np.pi * d / s
    xs = np.where(x != 0, x, 1.0)
    return np.where(x != 0, 2.0 / s * np.sin(xs) / xs,
                    np.broadcast_to(2.0 / s, x.shape))


SLIT_SHAPES = {
    "triangle": _tri,
    "gaussian": _gauss,
    "rectangular": _rect,
    "dispersion": _lorentz_slit,
    "cosine": _cosine,
    "diffraction": _diffraction,
    "michelson": _michelson,
}


def ils_matrix(X, centers, widths, shape: str = "triangle",
               shift: float = 0.0, scale: float = 1.0,
               normalize: bool = True) -> np.ndarray:
    """Dense (nX, n_chan) float64 ILS weight matrix on the host,
    column-normalized; the effective centre is ``scale * center + shift``
    (``ILS_MAKO``'s calibration parameters, ``radiative_transfer.py:1242``)."""
    X = as_numpy(X, np.float64)
    centers = as_numpy(centers, np.float64)
    widths = np.broadcast_to(as_numpy(widths, np.float64),
                             centers.shape)
    d = X[:, None] - (scale * centers[None, :] + shift)
    W = SLIT_SHAPES[shape](d, widths[None, :])
    if normalize:
        n = W.sum(axis=0)
        n = np.where(n == 0, 1.0, n)
        W = W / n
    return W


def apply_ils(W, Y, device=None) -> torch.Tensor:
    """Convolve: (nX, n_chan)^T @ (nX[, nS]) -> (n_chan[, nS]), one dense
    product. ``Y`` (array or tensor) is used on ``device`` (None: ``Y``'s
    own where it is a tensor, else the card), ``W`` in ``Y``'s float dtype
    (float64 for non-float input)."""
    if device is None and isinstance(Y, torch.Tensor):
        device = Y.device
    Y = torch.as_tensor(Y, device=resolve_device(device))
    if not Y.is_floating_point():
        Y = Y.to(torch.float64)
    W = torch.as_tensor(as_numpy(W), dtype=Y.dtype, device=Y.device)
    return torch.tensordot(W, Y, dims=([0], [0]))


def ils_mako(X, Y, res_factor=None, return_x: bool = True,
             fwhm_sf: float = 1.0, shift: float = 0.0, scale: float = 1.0,
             shape: str = "triangle", device=None):
    """MAKO ILS convolution with the reference's semantics: width
    sigma = fwhm_sf |gradient(X_out)| 1.6 (``radiative_transfer.py:1241``;
    ``shape='gaussian'`` is the commented-out alternative, ``:1245-1248``).
    ``Y`` (nX[, nS]) on ``device`` as :func:`apply_ils`. Returns
    (x_out NumPy (n_chan,), y_out tensor), or y_out alone."""
    X = as_numpy(X)
    x_out = mako_axis_wn(X, res_factor)
    if x_out.size < 2:
        raise ValueError(
            f"only {x_out.size} MAKO channel(s) fall inside "
            f"[{X.min():.1f}, {X.max():.1f}] cm^-1; the MAKO band is "
            f"~760-1321 cm^-1 (7.57-13.16 µm)")
    sigma = fwhm_sf * np.abs(np.gradient(x_out)) * 1.6
    W = ils_matrix(X, x_out, sigma, shape=shape, shift=shift, scale=scale)
    y_out = apply_ils(W, Y, device=device)
    return (x_out, y_out) if return_x else y_out


def ils_mako_simple(X, Y, device=None):
    """The standalone Gaussian MAKO ILS (``ILS_MAKO.py:2-35``): sigma =
    |gradient(X_out)| (no 1.6, no calibration parameters), no in-band
    trim, the matrix normalized by its column sums. Returns (X_out, Y_out)."""
    X = as_numpy(X, np.float64)
    x_out = np.sort(10000.0 / _mako_table())
    sigma = np.abs(np.gradient(x_out))
    W = ils_matrix(X, x_out, sigma, shape="gaussian", normalize=True)
    return x_out, apply_ils(W, Y, device=device)
