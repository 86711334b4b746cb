"""Spectral smoothing and resolution reduction (counterpart of
``radtxfr_tpu/sensor/resolution.py``).

The reference's ``smooth`` (reflected-edge window convolution,
``radiative_transfer.py:1266-1324``) and ``reduceResolution`` (a symmetric
window smooth followed by a 4-point cubic resample onto a coarser axis,
``:1327-1350``), in two forms:

* :func:`reduce_resolution`: the smooth on the device (a 1-D convolution of
  the reflected-edge signal) and the static host-built resample stencil
  applied as a gather and a weighted sum; any axis, edges included;
* :class:`ReduceOperator` (:func:`reduce_operator`): both steps are linear
  with local support, so away from the edges their composition is one
  banded operator: output i is a fixed-width dot product against fine-grid
  values starting at ``starts[i]``. It is precomputed on the host in
  float64 and applied on the device, so only reduced spectra leave it.

Plain PyTorch: the JAX package also computes these outside its kernels.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import arrays_on, as_numpy, resolve_device
from ..utils.profiling import span

__all__ = ["smooth", "reduce_resolution", "cubic_resample_weights",
           "apply_resample", "ReduceOperator", "reduce_operator"]

_WINDOWS = {
    "flat": lambda n: np.ones(n),
    "hanning": np.hanning,
    "hamming": np.hamming,
    "bartlett": np.bartlett,
    "blackman": np.blackman,
}


def smooth(x: torch.Tensor, window_len: int = 11,
           window: str = "hanning", device=None) -> torch.Tensor:
    """Reflected-edge window smoothing with the reference's semantics
    (``radiative_transfer.py:1298-1324``): a tensor of ``len(x)``; ``x``
    itself when ``window_len`` is under 3 or over ``len(x)``. A NumPy
    ``x`` goes to ``device`` (None: the card)."""
    x, = arrays_on(x, device=device, lead=True)
    n = x.shape[0]
    if window_len < 3 or n < window_len:
        return x
    if window not in _WINDOWS:
        raise ValueError(f"window must be one of {sorted(_WINDOWS)}")
    w = _WINDOWS[window](window_len)
    w = torch.as_tensor(w / w.sum(), dtype=x.dtype, device=x.device)
    s = torch.cat([x[1:window_len].flip(0), x,
                   x[n - window_len:n - 1].flip(0)])
    # conv1d correlates: the flipped window makes it numpy's convolution
    y = torch.nn.functional.conv1d(s[None, None], w.flip(0)[None, None])[0, 0]
    ix0 = int(np.ceil(window_len / 2 - 1))
    ix1 = y.shape[0] - int(np.floor(window_len / 2))
    return y[ix0:ix1]


def _sym_smooth(y: torch.Tensor, window_len: int, window: str):
    """0.5 (smooth(y) + smooth(y[::-1])[::-1])
    (``radiative_transfer.py:1331``)."""
    return 0.5 * (smooth(y, window_len, window)
                  + smooth(y.flip(0), window_len, window).flip(0))


def cubic_resample_weights(x_in: np.ndarray, x_out: np.ndarray):
    """Static 4-point Lagrange interpolation stencil (idx (n_out, 4) int32,
    weights (n_out, 4) float64); edge stencils extrapolate."""
    x_in = as_numpy(x_in, np.float64)
    x_out = as_numpy(x_out, np.float64)
    n = x_in.size
    j = np.searchsorted(x_in, x_out, side="right") - 1
    base = np.clip(j - 1, 0, n - 4)
    idx = base[:, None] + np.arange(4)[None, :]
    xs = x_in[idx]
    w = np.ones((x_out.size, 4))
    for k in range(4):
        for m in range(4):
            if m == k:
                continue
            w[:, k] *= (x_out - xs[:, m]) / (xs[:, k] - xs[:, m])
    return idx.astype(np.int32), w


def apply_resample(idx, w, y: torch.Tensor, device=None) -> torch.Tensor:
    """Apply a static resample stencil (:func:`cubic_resample_weights`) to
    ``y`` (nX[, ...]) along axis 0, on ``y``'s device (a NumPy ``y`` on
    ``device``, None: the card)."""
    y, = arrays_on(y, device=device, lead=True)
    idx = torch.as_tensor(as_numpy(idx, np.int64), device=y.device)
    w = torch.as_tensor(as_numpy(w), dtype=y.dtype, device=y.device)
    g = y[idx]                                    # (n_out, 4[, ...])
    return torch.sum(g * w.reshape(w.shape + (1,) * (y.dim() - 1)), dim=1)


def _np_sym_smooth(x, sm: int, window: str):
    """Host float64 forward+reverse reflected-edge smooth average, the
    reference's pre-smoothing (``radiative_transfer.py:1337-1340``)."""
    w = _WINDOWS[window](sm)
    w = w / w.sum()

    def one(v):
        s = np.r_[v[sm - 1:0:-1], v, v[-2:-sm - 1:-1]]
        y = np.convolve(w, s, mode="valid")
        return y[int(np.ceil(sm / 2 - 1)): y.size - int(np.floor(sm / 2))]

    return 0.5 * (one(x) + one(x[::-1])[::-1])


def reduce_resolution(X, Y: torch.Tensor, dX, N: int = 4,
                      window: str = "hanning", X_out=None, device=None):
    """Smooth and resample ``Y`` (nX[, ...]) onto a coarser axis, the
    reference's ``reduceResolution`` (``radiative_transfer.py:1327-1350``).

    ``X`` is the static host axis; the axis is smoothed on the host in
    float64 (smoothing it in float32 can give duplicate nodes that break
    the stencil), ``Y`` on its device (a NumPy ``Y`` on ``device``, None:
    the card), each trailing column alone. Returns ``(X_out, Y_out)``, or
    ``Y_out`` when ``X_out`` is given.
    """
    Y, = arrays_on(Y, device=device, lead=True)
    X = as_numpy(X, np.float64)
    dX = float(dX)
    dx_in = float(np.mean(np.diff(X)))
    sm = int(round(dX / dx_in))
    x_sm = _np_sym_smooth(X, sm, window)
    return_x = X_out is None
    if X_out is None:
        n_pts = int(np.ceil(N * (x_sm[-sm - 1] - x_sm[sm]) / dX)) + 1
        X_out = np.linspace(x_sm[sm], x_sm[-sm - 1], n_pts)
    idx, w = cubic_resample_weights(x_sm, X_out)
    cols = Y.reshape(Y.shape[0], -1)
    y_sm = torch.stack([_sym_smooth(cols[:, j], sm, window)
                        for j in range(cols.shape[1])], dim=1)
    y_out = apply_resample(idx, w, y_sm.reshape(Y.shape))
    return (X_out, y_out) if return_x else y_out


class ReduceOperator:
    """``reduce_resolution`` fused into one static banded stencil, applied
    along axis 0: (nX[, ...]) -> (n_out[, ...]).

    Uniform axes take the gather-free strided-frame form (see
    :meth:`_build_affine`); other axes gather the (n_out, width) windows.
    """

    def __init__(self, x_out: np.ndarray, starts: np.ndarray,
                 weights: np.ndarray, device=None):
        self.x_out = as_numpy(x_out)
        starts, weights = as_numpy(starts, np.int64), as_numpy(weights)
        self.n_out, self.width = weights.shape
        self.device = device = resolve_device(device)
        self.starts = torch.as_tensor(starts, device=device)
        self.weights = torch.as_tensor(weights, device=device)
        self._offsets = torch.arange(self.width, device=device)
        self._affine = self._build_affine(starts, weights, device)

    @staticmethod
    def _build_affine(starts, weights, device, max_jitter: int = 8):
        """Strided-frame form: for uniform axes starts[i] = s0 i + b0 + r[i]
        with a small jitter r; then with F[i, m] = Y[b0 + s0 i + m] and
        zero-padded wide weights w~[i, r[i] - r_min + j] = weights[i, j],
        out[i] = sum_m w~[i, m] F[i, m], and F is a concatenation of
        ceil(W'/s0) shifted views of the stride-s0 reshape of Y (slices and
        reshapes only). None when the rows are not near-affine."""
        n_out = starts.shape[0]
        if n_out < 2:
            return None
        s0 = int(np.round(np.mean(np.diff(starts))))
        if s0 < 1:
            return None
        r = starts - starts[0] - s0 * np.arange(n_out, dtype=np.int64)
        r_min, r_max = int(r.min()), int(r.max())
        if r_max - r_min > max_jitter:
            return None
        width = weights.shape[1]
        w_wide = np.zeros((n_out, width + (r_max - r_min)), weights.dtype)
        for off in range(r_max - r_min + 1):
            rows = np.nonzero(r == r_min + off)[0]
            w_wide[rows, off:off + width] = weights[rows]
        b0 = int(starts[0]) + r_min
        return s0, b0, torch.as_tensor(w_wide, device=device)

    def _apply_affine(self, Y):
        s0, b0, w_wide = self._affine
        n = Y.shape[0]
        n_out, w_prime = w_wide.shape
        k = -(-w_prime // s0)
        need = b0 + (n_out + k) * s0
        pad_front = max(0, -b0)
        pad_end = max(0, need + pad_front - n)
        if pad_front or pad_end:
            pad = torch.zeros((pad_front,) + Y.shape[1:], dtype=Y.dtype,
                              device=Y.device)
            tail = torch.zeros((pad_end,) + Y.shape[1:], dtype=Y.dtype,
                               device=Y.device)
            Y = torch.cat([pad, Y, tail])
        lo = b0 + pad_front
        frames = Y[lo:lo + (n_out + k) * s0].reshape(
            (n_out + k, s0) + Y.shape[1:])
        f = torch.cat([frames[q:q + n_out] for q in range(k)], dim=1)
        f = f[:, :w_prime]
        w = w_wide.to(Y.dtype).reshape(w_wide.shape + (1,) * (Y.dim() - 1))
        return torch.sum(f * w, dim=1)

    def __call__(self, Y: torch.Tensor) -> torch.Tensor:
        """``Y`` (nX[, ...]) reduced along axis 0; a NumPy ``Y`` goes to
        the operator's device in its own dtype. Span ``reduce``."""
        with span("reduce"):
            Y, = arrays_on(Y, device=self.device, lead=True)
            if self._affine is not None:
                return self._apply_affine(Y)
            g = Y[self.starts[:, None] + self._offsets[None, :]]
            w = self.weights.to(Y.dtype)
            return torch.sum(g * w.reshape(w.shape + (1,) * (Y.dim() - 1)),
                             dim=1)


def reduce_operator(X, dX, N: int = 4, window: str = "hanning", X_out=None,
                    device=None) -> ReduceOperator:
    """Build the fused :class:`ReduceOperator` for a static fine axis ``X``,
    matching the reference's ``reduceResolution(X, Y, dX, N, window)`` for
    interior stencils; raises ValueError when there is nothing to reduce or
    a stencil would cross the grid edge. ``device`` None is the card."""
    X = as_numpy(X, np.float64)
    dX = float(dX)
    n = X.size
    dx_in = float(np.mean(np.diff(X)))
    sm = int(round(dX / dx_in))
    if sm < 3:
        raise ValueError(f"smoothing window {sm} < 3: nothing to reduce")
    if window not in _WINDOWS:
        raise ValueError(f"window must be one of {sorted(_WINDOWS)}")

    x_sm = _np_sym_smooth(X, sm, window)
    if X_out is None:
        n_pts = int(np.ceil(N * (x_sm[-sm - 1] - x_sm[sm]) / dX)) + 1
        X_out = np.linspace(x_sm[sm], x_sm[-sm - 1], n_pts)
    X_out = as_numpy(X_out, np.float64)
    idx, w = cubic_resample_weights(x_sm, X_out)

    # interior symmetric-smooth impulse response (half-width sm // 2)
    half = sm // 2
    m = 4 * sm + 17
    imp = np.zeros(m)
    imp[m // 2] = 1.0
    resp = _np_sym_smooth(imp, sm, window)
    K = resp[m // 2 - half: m // 2 + half + 1]

    # composed rows: C[i, l] = sum_k w[i, k] * K[l - k]
    base = idx[:, 0].astype(np.int64)
    width = 2 * half + 1 + 3
    starts = base - half
    if starts.min() < 0 or int(starts.max()) + width > n:
        raise ValueError(
            "reduce_operator: a composed stencil crosses the fine-grid edge "
            "(X_out reaches into the reflected-smoothing zone)")
    C = np.zeros((X_out.size, width))
    for k in range(4):
        C[:, k:k + 2 * half + 1] += w[:, k:k + 1] * K[None, :]
    return ReduceOperator(X_out, starts, C, device=device)
