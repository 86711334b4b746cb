"""Spectral-grid construction (host NumPy; grids are static inputs).

Counterpart of ``radtxfr_tpu/core/grid.py``: ``arange_drift_free``
reproduces hapi's drift-free ``arange_`` (``misc/hapi.py:133-139``).
"""

from __future__ import annotations

import numpy as np


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
