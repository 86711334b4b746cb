"""Numeric-precision guards (counterpart of
``radtxfr_tpu/utils/precision.py``)."""

from __future__ import annotations

import functools

import torch

__all__ = ["f32_matmuls"]


def f32_matmuls(fn):
    """Full float32 matmuls and convolutions inside ``fn``: TF32 off for
    the call, the previous settings restored afterwards.

    A float32 product in TF32 keeps ~3 decimal digits (the card's form of
    the TPU's bfloat16 matmul default) - acceptable for NN training, not
    for parity surfaces or small-matrix statistics. Applied to the
    scene-model entry points (PCA/GMM/ICA/NMF/B-spline) and usable on any
    function whose matmuls must stay exact.
    """

    @functools.wraps(fn)
    def wrapped(*a, **k):
        prev = (torch.backends.cuda.matmul.allow_tf32,
                torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        try:
            return fn(*a, **k)
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = prev
    return wrapped
