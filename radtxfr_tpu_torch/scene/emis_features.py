"""Emissivity feature compression: OD transform + PCA / ICA / NMF / B-splines
(counterpart of ``radtxfr_tpu/scene/emis_features.py``).

The reference's emissivity-compression block
(``Generate_Emissivity_DB.py:93-193``): clamp emissivities to
``[TOL, 1-TOL]``, work in optical depth ``OD = -log(1 - eps)``, where
spectra are additive and non-negative, and compress the material axis with

* whitened PCA (sklearn ``PCA(whiten=True, n_components=48)``, ``:111``),
* FastICA (``FastICA(n_components=36)``, ``:114-118``): symmetric
  decorrelation with the logcosh contrast,
* NMF (``NMF(n_components=48)``, ``:120-123``): Lee–Seung multiplicative
  updates,
* a cubic B-spline least-squares fit of ``-log(eps)`` on uniform interior
  knots, reconstructed as ``eps = exp(-|spline|)`` (``:126-142``): one
  design matrix and one minimum-norm solve for every material.

Plain PyTorch with fixed iteration counts (no host synchronisation inside
the loops). The random initial factors come from an explicit
``torch.Generator``; the private cores ``_fast_ica`` and ``_nmf`` take
them, so a fit is reproducible from given draws on any device. The
least-squares solve is SVD-based (``torch.linalg.pinv``) on every device:
the minimum-norm solution of JAX's ``lstsq``, where CUDA's ``lstsq`` offers
only a QR that assumes full rank.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import as_tensor_on
from ..utils.precision import f32_matmuls as _f32_matmuls
from .generative import PCAModel, pca_fit

__all__ = [
    "od_transform", "od_inverse", "pca_compress",
    "ICAModel", "fast_ica",
    "NMFModel", "nmf",
    "bspline_design", "BSplineFit", "bspline_fit_emissivity",
]


def od_transform(emis, tol: float = 1e-4):
    """Emissivity -> optical depth ``-log(1 - eps)`` with the reference's
    TOL clamp (``Generate_Emissivity_DB.py:105-107,111``)."""
    eps = torch.clamp(as_tensor_on(emis), tol, 1.0 - tol)
    return -torch.log1p(-eps)


def od_inverse(od):
    """Optical depth -> emissivity ``1 - exp(-OD)`` (``:116,122``)."""
    return -torch.expm1(-as_tensor_on(od))


@_f32_matmuls
def pca_compress(emis, n_components: int = 48, tol: float = 1e-4):
    """Whitened PCA of the OD-transformed emissivity matrix: returns
    ``(model, features, emis_recon)``, the features the whitened scores,
    the reconstruction through :func:`od_inverse`."""
    od = od_transform(emis, tol)
    model: PCAModel = pca_fit(od, n_components)
    feats = model.transform(od)
    return model, feats, od_inverse(model.inverse_transform(feats))


# ---------------------------------------------------------------------------
# FastICA (symmetric decorrelation, logcosh contrast)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ICAModel:
    mean: torch.Tensor    # (d,)
    whiten: torch.Tensor  # (k, d) whitening matrix (PCA-based)
    unmix: torch.Tensor   # (k, k) rotation found by FastICA
    mixing: torch.Tensor  # (d, k) mixing matrix (sklearn's ``mixing_``)

    @_f32_matmuls
    def transform(self, X):
        """Data -> independent sources (n, k)."""
        X = as_tensor_on(X, self.mean.device, self.mean.dtype)
        return ((X - self.mean) @ self.whiten.T) @ self.unmix.T

    @_f32_matmuls
    def inverse_transform(self, S):
        """Sources -> data space (n, d)."""
        S = as_tensor_on(S, self.mean.device, self.mean.dtype)
        return S @ self.mixing.T + self.mean


def _sym_decorrelate(W):
    """W <- (W W^T)^{-1/2} W via eigen-decomposition."""
    s, u = torch.linalg.eigh(W @ W.T)
    s = torch.clamp(s, min=1e-12)
    return (u * (1.0 / torch.sqrt(s))) @ u.T @ W


def _fast_ica(X, W0, n_iter: int = 200) -> ICAModel:
    """FastICA from the raw (k, k) initial matrix ``W0`` (decorrelated
    here). The whitening's signs are the SVD's: flipping whitening row i
    and column i of ``W0`` gives the same sources."""
    n = X.shape[0]
    mean = X.mean(dim=0)
    Xc = X - mean
    _, s, Vt = torch.linalg.svd(Xc, full_matrices=False)
    k = W0.shape[0]
    # rcond guard: a near-null direction (s ~ 0) must not be amplified to
    # numerical noise by the whitening division
    s_safe = torch.maximum(s[:k], s[0] * 1e-9)
    whiten = Vt[:k] / (s_safe[:, None] / np.sqrt(n))
    Xw = Xc @ whiten.T                      # (n, k), unit covariance
    W = _sym_decorrelate(W0)
    for _ in range(n_iter):
        g = torch.tanh(Xw @ W.T)            # logcosh contrast derivative
        g_prime = (1.0 - g * g).mean(dim=0)
        W = _sym_decorrelate((g.T @ Xw) / n - g_prime[:, None] * W)
    # mixing matrix: pseudo-inverse of the full unmixing map (k x d)
    mixing = torch.linalg.pinv(W @ whiten)
    return ICAModel(mean=mean, whiten=whiten, unmix=W, mixing=mixing)


@_f32_matmuls
def fast_ica(X, n_components: int, generator: torch.Generator | None = None,
             n_iter: int = 200) -> ICAModel:
    """Parallel (symmetric) FastICA with the logcosh contrast (sklearn
    ``FastICA`` as ``Generate_Emissivity_DB.py:114`` uses it): PCA-whiten
    to ``n_components``, then ``n_iter`` fixed-point iterations
    ``W <- E[g(WX) X^T] - E[g'(WX)] W`` with symmetric decorrelation, from a
    standard-normal ``W0`` drawn from ``generator`` (seed 0 when None)."""
    X = as_tensor_on(X)
    if generator is None:
        generator = torch.Generator(device=X.device).manual_seed(0)
    W0 = torch.randn((n_components, n_components), generator=generator,
                     device=generator.device, dtype=X.dtype)
    return _fast_ica(X, W0.to(X.device), n_iter=n_iter)


# ---------------------------------------------------------------------------
# NMF (Lee–Seung multiplicative updates, Frobenius loss)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class NMFModel:
    W: torch.Tensor  # (n, k) per-sample activations
    H: torch.Tensor  # (k, d) non-negative basis spectra

    @_f32_matmuls
    def inverse_transform(self, W=None):
        W = self.W if W is None else as_tensor_on(W, self.H.device,
                                                  self.H.dtype)
        return W @ self.H


def _nmf(X, W0, H0, n_iter: int = 400, eps: float = 1e-9) -> NMFModel:
    """Lee–Seung updates from the initial factors ``W0`` (n, k) and ``H0``
    (k, d): ``n_iter`` fixed steps."""
    W, H = W0, H0
    for _ in range(n_iter):
        H = H * (W.T @ X) / (W.T @ W @ H + eps)
        W = W * (X @ H.T) / (W @ (H @ H.T) + eps)
    return NMFModel(W=W, H=H)


@_f32_matmuls
def nmf(X, n_components: int, generator: torch.Generator | None = None,
        n_iter: int = 400, eps: float = 1e-9) -> NMFModel:
    """Non-negative matrix factorization ``X ~= W H`` (Frobenius loss;
    sklearn ``NMF`` as ``Generate_Emissivity_DB.py:120`` uses it) by
    multiplicative updates from |standard normal| factors, scaled by
    sqrt(mean(X) / k), drawn from ``generator`` (seed 0 when None). ``X``
    must be non-negative (OD space)."""
    X = as_tensor_on(X)
    n, d = X.shape
    k = n_components
    if generator is None:
        generator = torch.Generator(device=X.device).manual_seed(0)
    draw = lambda shape: torch.randn(  # noqa: E731
        shape, generator=generator, device=generator.device,
        dtype=X.dtype).to(X.device)
    scale = torch.sqrt(torch.clamp(X.mean(), min=eps) / k)
    W0 = scale * torch.abs(draw((n, k)))
    H0 = scale * torch.abs(draw((k, d)))
    return _nmf(X, W0, H0, n_iter=n_iter, eps=eps)


# ---------------------------------------------------------------------------
# Cubic B-spline least-squares fit
# ---------------------------------------------------------------------------

def bspline_design(x, n_knots: int, degree: int = 3) -> np.ndarray:
    """Dense B-spline design matrix (len(x), n_knots + degree - 1) on the
    host in float64: uniform interior knots spanning [x.min(), x.max()]
    (the reference's ``np.linspace(X.min(), X.max(), N)[1:-1]`` passed to
    ``splrep``, ``Generate_Emissivity_DB.py:127``), clamped end knots,
    Cox–de Boor recursion."""
    x = np.asarray(x, dtype=np.float64)
    lo, hi = float(x.min()), float(x.max())
    interior = np.linspace(lo, hi, n_knots)[1:-1]
    t = np.concatenate([np.full(degree + 1, lo), interior,
                        np.full(degree + 1, hi)])
    n_coef = len(t) - degree - 1
    B = np.zeros((x.size, len(t) - 1))
    for j in range(len(t) - 1):
        B[:, j] = (x >= t[j]) & (x < t[j + 1])
    # the last basis includes the right endpoint
    B[x == hi, np.searchsorted(t, hi, side="left") - 1] = 1.0
    for p in range(1, degree + 1):
        Bp = np.zeros((x.size, len(t) - 1 - p))
        for j in range(len(t) - 1 - p):
            d1 = t[j + p] - t[j]
            d2 = t[j + p + 1] - t[j + 1]
            term = 0.0
            if d1 > 0:
                term = (x - t[j]) / d1 * B[:, j]
            if d2 > 0:
                term = term + (t[j + p + 1] - x) / d2 * B[:, j + 1]
            Bp[:, j] = term
        B = Bp
    return B[:, :n_coef]


@dataclasses.dataclass(frozen=True)
class BSplineFit:
    design: torch.Tensor  # (nX, n_coef) B-spline basis on the fit axis
    coefs: torch.Tensor   # (n_mat, n_coef) per-material spline coefficients

    @_f32_matmuls
    def reconstruct(self):
        """emis = exp(-|B c|) per material (the reference's ``emisFcn``,
        ``Generate_Emissivity_DB.py:137-139``) -> (nX, n_mat)."""
        return torch.exp(-torch.abs(self.design @ self.coefs.T))


@_f32_matmuls
def bspline_fit_emissivity(X, emis, n_knots: int = 48, degree: int = 3,
                           tol: float = 1e-4) -> BSplineFit:
    """Fit ``-log(eps)`` of every material with one minimum-norm
    least-squares solve (the reference's per-material ``splrep`` loop,
    ``Generate_Emissivity_DB.py:130-134``). ``emis`` is (nX, n_mat) on
    axis ``X``, spectral axis first."""
    emis = torch.clamp(as_tensor_on(emis), tol, 1.0 - tol)
    y = -torch.log(emis)                              # (nX, n_mat)
    B = as_tensor_on(bspline_design(X, n_knots, degree), y.device, y.dtype)
    coefs = torch.linalg.pinv(B) @ y                  # (n_coef, n_mat)
    return BSplineFit(design=B, coefs=coefs.T)
