"""Spectral-grid construction (host NumPy; grids are static inputs).

Counterpart of ``radtxfr_tpu/core/grid.py``: ``make_spectral_axis``
reproduces the ``np.linspace`` axis of ``radiative_transfer.py:251-271``
(N = ceil((x_max - x_min)/dv) points, so the realised spacing differs
slightly from ``dv``); ``arange_drift_free`` hapi's drift-free ``arange_``
(``misc/hapi.py:133-139``).
"""

from __future__ import annotations

import numpy as np


def make_spectral_axis(x_min: float, x_max: float, dv: float) -> np.ndarray:
    """Uniform spectral axis from ``x_min`` to ``x_max`` (inclusive) with
    ``ceil((x_max - x_min)/dv)`` points (``radiative_transfer.py:269-271``)."""
    n = int(np.ceil((x_max - x_min) / dv))
    return np.linspace(x_min, x_max, n)


def arange_drift_free(lower: float, upper: float, step: float) -> np.ndarray:
    """Drift-free arange, exactly matching hapi's ``arange_``.

    Reference: ``misc/hapi.py:133-139``.
    """
    npnt = int(np.floor((upper - lower) / step)) + 1
    upper_new = lower + step * (npnt - 1)
    if abs((upper - upper_new) - step) < 1e-10:
        upper_new += step
        npnt += 1
    return np.linspace(lower, upper_new, npnt)


def pad_to_multiple(n: int, m: int) -> int:
    """Smallest multiple of ``m`` that is >= ``n``."""
    return ((n + m - 1) // m) * m
