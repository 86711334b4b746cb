"""Array shape utilities, spectral axis first (counterpart of
``radtxfr_tpu/core/reshape.py``): the reference's ``rs1D``/``rs2D``/``rsND``
(``radiative_transfer.py:186-248``) collapse trailing dimensions for 2-D
batched spectral math and restore them afterwards. A tensor stays on its
device; any other array goes to ``device`` (None: the card).
"""

from __future__ import annotations

import math

import torch

from .. import as_tensor_on

__all__ = ["rs1d", "rs2d", "rsnd"]


def rs1d(y, device=None):
    """Flatten to 1-D; return (flat, original_shape)."""
    y = as_tensor_on(y, device) if not torch.is_tensor(y) else y
    return y.reshape(-1), tuple(y.shape)


def rs2d(y, device=None):
    """Collapse to 2-D with the spectral (first) axis kept; 1-D and 0-D
    inputs become a row vector, as ``rs2D``
    (``radiative_transfer.py:222-225``). Returns (2-D tensor, shape to
    restore)."""
    y = as_tensor_on(y, device) if not torch.is_tensor(y) else y
    if y.dim() < 2:
        y = y.reshape(1, -1)
        return y, tuple(y.shape)
    dims = tuple(y.shape)
    return y.reshape(dims[0], math.prod(dims[1:])), dims


def rsnd(y, dims, device=None):
    """Restore a tensor collapsed by :func:`rs1d`/:func:`rs2d`."""
    y = as_tensor_on(y, device) if not torch.is_tensor(y) else y
    return y.reshape(dims)
