"""Array shape utilities, spectral axis first (counterpart of
``radtxfr_tpu/core/reshape.py``): the reference's ``rs1D``/``rs2D``/``rsND``
(``radiative_transfer.py:186-248``) collapse trailing dimensions for 2-D
batched spectral math and restore them afterwards.
"""

from __future__ import annotations

import math

import torch

__all__ = ["rs1d", "rs2d", "rsnd"]


def rs1d(y):
    """Flatten to 1-D; return (flat, original_shape)."""
    y = torch.as_tensor(y)
    return y.reshape(-1), tuple(y.shape)


def rs2d(y):
    """Collapse to 2-D with the spectral (first) axis kept; 1-D and 0-D
    inputs become a row vector, as ``rs2D``
    (``radiative_transfer.py:222-225``). Returns (2-D tensor, shape to
    restore)."""
    y = torch.as_tensor(y)
    if y.dim() < 2:
        y = y.reshape(1, -1)
        return y, tuple(y.shape)
    dims = tuple(y.shape)
    return y.reshape(dims[0], math.prod(dims[1:])), dims


def rsnd(y, dims):
    """Restore a tensor collapsed by :func:`rs1d`/:func:`rs2d`."""
    return torch.as_tensor(y).reshape(dims)
