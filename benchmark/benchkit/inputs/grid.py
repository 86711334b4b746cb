"""The spectral axis rule (hapi's drift-free ``arange_``, ``misc/hapi.py:
133-139``; ``radtxfr_tpu_torch/core/grid.py:22-32``):
``floor((upper - lower) / step) + 1`` points from ``lower`` by ``step``,
one more where rounding leaves ``upper`` a step away."""

from __future__ import annotations

import numpy as np


def axis(lower: float, upper: float, step: float) -> np.ndarray:
    n = int(np.floor((upper - lower) / step)) + 1
    top = lower + step * (n - 1)
    if abs((upper - top) - step) < 1e-10:
        top += step
        n += 1
    return np.linspace(lower, top, n)
