"""Robust statistics and scene-statistics transmittance estimation
(counterpart of ``radtxfr_tpu/scene/robust.py``): working versions of the
algorithms of the reference's ``misc/working_with_HSI.py`` (checked in
broken, SURVEY.md §2.2):

* :func:`mad` — median absolute deviation (``:13``);
* :func:`robust_z` — MAD-normalized robust z-scores (``:17``);
* :func:`qn_scale` — the Rousseeuw-Croux Qn scale estimator (``:33``);
* :func:`estimate_tau` — the iterative scene-statistics estimate of
  relative transmittance from an HSI cube (``estimate_tau``, ``:86-99``).

Medians are NumPy's (the mean of the two middle values for an even
count), not ``torch.median``'s lower middle value.
"""

from __future__ import annotations

import torch

from .. import arrays_on

__all__ = ["mad", "robust_z", "qn_scale", "estimate_tau"]


def _median(x, dim=None, keepdim=False):
    if dim is None:
        return torch.quantile(x.reshape(-1), 0.5)
    return torch.quantile(x, 0.5, dim=dim, keepdim=keepdim)


def mad(x, axis=None, scale: float = 1.4826, device=None):
    """Median absolute deviation (scaled to sigma for normal data)."""
    x, = arrays_on(x, device=device, lead=True)
    med = _median(x, axis, keepdim=True)
    return scale * _median(torch.abs(x - med), axis)


def robust_z(x, axis=None, device=None):
    """(x - median) / MAD robust z-scores."""
    x, = arrays_on(x, device=device, lead=True)
    med = _median(x, axis, keepdim=True)
    s = mad(x, axis=axis)
    if axis is not None:
        s = s.unsqueeze(axis)
    return (x - med) / s


def qn_scale(x, device=None):
    """Rousseeuw-Croux Qn scale estimator (1-D): 2.2219 times the
    C(h, 2)-th smallest pairwise distance, h = floor(n/2) + 1 (the O(n^2)
    pairwise form, for subsampled scene vectors)."""
    x, = arrays_on(x, device=device, lead=True)
    x = x.reshape(-1)
    n = x.shape[0]
    iu = torch.triu_indices(n, n, offset=1, device=x.device)
    pair = torch.abs(x[iu[0]] - x[iu[1]])
    h = n // 2 + 1
    k = h * (h - 1) // 2
    return 2.2219 * torch.sort(pair).values[k - 1]


def estimate_tau(L, n_iter: int = 5, smooth_window: int = 31, device=None):
    """Relative transmittance shape from the scene statistics of an
    (n_pixels, nX) radiance array: the normalized robust scene std, lightly
    smoothed (``n_iter`` half-steps towards a ``smooth_window`` box mean,
    zero-padded like ``np.convolve(mode='same')``), in [0, 1]."""
    L, = arrays_on(L, device=device, lead=True)
    sigma = mad(L, axis=0)
    est = sigma / torch.max(sigma)
    w = torch.ones(smooth_window, dtype=est.dtype,
                   device=est.device) / smooth_window
    n = est.shape[0]
    for _ in range(n_iter):
        full = torch.nn.functional.conv1d(
            est[None, None], w.flip(0)[None, None],
            padding=smooth_window - 1)[0, 0]
        lo = (full.shape[0] - n) // 2
        est = 0.5 * (est + full[lo:lo + n])
    est = est / torch.max(est)
    return torch.clamp(est, 0.0, 1.0)
