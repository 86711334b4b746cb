"""Generative atmosphere-ensemble model: PCA + GMM (counterpart of
``radtxfr_tpu/scene/generative.py``), the reference's
``GenerativeModel_AtmosInputs.py`` pipeline in plain PyTorch on one device:

* whitened PCA + a Gaussian-mixture density over feature vectors (the
  reference's sklearn ``PCA(whiten=True)`` +
  ``BayesianGaussianMixture(covariance_type='full')``, ``:17-46``): SVD PCA
  and a variational GMM with the Dirichlet-process stick-breaking weight
  prior (:func:`bgmm_fit`), so surplus components prune themselves, with
  MAP mean/covariance updates (the JAX package's documented
  simplification); plain EM in :func:`gmm_fit`;
* the physics feature transforms (``trans_T``/``itrans_T``, ``:90-126``;
  ``trans_C``/``itrans_C``, ``:128-165``; ``mf2mol_cum``/``mol_cum2mf``,
  ``:61-77``) with the same plausibility rejections;
* the supersaturation filter (``RH_filter``, ``:79-84``) on a Bolton-1980
  saturation vapour pressure, with the P < 101325 e^-3 zeroing;
* ``atmos_generator`` with 5x oversampling and rejection (``:212-243``),
  air-mass clustering (``airmass_labels``, ``:391-419``) and per-air-mass
  augmentation (``gen_samples_per_airmass``, ``:421-443``).

Draws come from an explicit ``torch.Generator``; each fit has a private
core that takes its initial draws (``_gmm_fit``, ``_bgmm_fit``), so a fit
is reproducible from given draws on any device. The fixed-count EM and VB
loops make no host synchronisation. Standard deviations are the
population ones (ddof 0), covariances the sample ones (``np.cov``), as in
the JAX package. A Cholesky factor of a matrix that is not positive
definite is NaN (JAX's outcome), not an exception.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from .. import as_tensor_on
from ..utils.precision import f32_matmuls as _f32_matmuls

__all__ = [
    "PCAModel", "pca_fit",
    "GMMModel", "gmm_fit", "bgmm_fit", "gmm_prune", "gmm_sample",
    "gmm_log_prob", "gmm_predict",
    "mf2mol_cum", "mol_cum2mf", "mf2rh", "rh_filter",
    "trans_T", "itrans_T", "trans_C", "itrans_C",
    "atmos_to_features", "features_to_atmos",
    "atmos_generator", "airmass_labels", "gen_samples_per_airmass",
]


def _std(x, dim=None):
    """Population standard deviation (NumPy's and JAX's default ddof 0)."""
    return torch.std(x, dim=dim, correction=0)


def _cholesky(a):
    """Lower Cholesky factors of (..., d, d); a factor whose matrix is not
    positive definite is NaN on and below the diagonal, as
    ``jnp.linalg.cholesky`` gives (``torch.linalg.cholesky`` raises)."""
    L, info = torch.linalg.cholesky_ex(a)
    bad = (info != 0)[..., None, None]
    return torch.where(bad, torch.full_like(L, float("nan")).tril(), L)


# ---------------------------------------------------------------------------
# PCA
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PCAModel:
    mean: torch.Tensor        # (d,)
    components: torch.Tensor  # (k, d) principal axes (rows)
    scale: torch.Tensor       # (k,) sqrt(explained variance), for whitening
    explained_variance_ratio: torch.Tensor  # (k,)

    @_f32_matmuls
    def transform(self, X):
        X = as_tensor_on(X, self.mean.device, self.mean.dtype)
        return ((X - self.mean) @ self.components.T) / self.scale

    @_f32_matmuls
    def inverse_transform(self, Z):
        Z = as_tensor_on(Z, self.mean.device, self.mean.dtype)
        return (Z * self.scale) @ self.components + self.mean


@_f32_matmuls
def pca_fit(X, n_components: int) -> PCAModel:
    """Whitened PCA by SVD (sklearn ``PCA(whiten=True)`` semantics). The
    components' signs are the SVD's, so compare reconstructions, not
    components, across implementations."""
    X = as_tensor_on(X)
    mean = X.mean(dim=0)
    _, s, Vt = torch.linalg.svd(X - mean, full_matrices=False)
    var = s**2 / (X.shape[0] - 1)
    return PCAModel(mean=mean, components=Vt[:n_components],
                    scale=torch.sqrt(var[:n_components]),
                    explained_variance_ratio=var[:n_components] / var.sum())


# ---------------------------------------------------------------------------
# Full-covariance Gaussian mixtures
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GMMModel:
    weights: torch.Tensor  # (K,)
    means: torch.Tensor    # (K, d)
    chols: torch.Tensor    # (K, d, d) lower Cholesky factors of covariances


def _maha(X, means, chols):
    """(N, K) squared Mahalanobis distances through triangular solves."""
    diff = (X[:, None, :] - means[None, :, :]).permute(1, 2, 0)  # (K, d, N)
    sol = torch.linalg.solve_triangular(chols, diff, upper=False)
    return torch.sum(sol**2, dim=1).T


def _log_gauss(X, means, chols):
    """(N, K) log N(x | mu_k, Sigma_k)."""
    d = X.shape[-1]
    logdet = torch.sum(torch.log(torch.diagonal(chols, dim1=-2, dim2=-1)),
                       dim=-1)
    return (-0.5 * (_maha(X, means, chols) + d * math.log(2.0 * math.pi))
            - logdet[None, :])


def _init_indices(generator, n, n_components, device):
    """K distinct rows of n (with replacement when n < K), the draws
    ``jax.random.choice`` makes in the JAX fits."""
    if n < n_components:
        return torch.randint(0, n, (n_components,), generator=generator,
                             device=generator.device).to(device)
    return torch.randperm(n, generator=generator,
                          device=generator.device)[:n_components].to(device)


def _gmm_fit(X, k0, n_iter: int = 200, reg: float = 1e-6) -> GMMModel:
    """EM from the initial means ``X[k0]``, a shared covariance and uniform
    weights: ``n_iter`` fixed steps."""
    n, d = X.shape
    K = k0.shape[0]
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    mu = X[k0]
    ch = _cholesky(torch.broadcast_to(torch.cov(X.T) + reg * eye, (K, d, d)))
    w = torch.full((K,), 1.0 / K, dtype=X.dtype, device=X.device)
    for _ in range(n_iter):
        logp = _log_gauss(X, mu, ch) + torch.log(w)[None, :]
        r = torch.exp(logp - torch.logsumexp(logp, dim=1, keepdim=True))
        nk = r.sum(dim=0) + 1e-10
        w = nk / n
        mu = (r.T @ X) / nk[:, None]
        diff = X[:, None, :] - mu[None, :, :]
        cov = (torch.einsum("nk,nki,nkj->kij", r, diff, diff)
               / nk[:, None, None])
        ch = _cholesky(cov + reg * eye[None])
    return GMMModel(weights=w, means=mu, chols=ch)


@_f32_matmuls
def gmm_fit(generator: torch.Generator, X, n_components: int,
            n_iter: int = 200, reg: float = 1e-6) -> GMMModel:
    """EM fit of a full-covariance GMM (plain maximum likelihood), seeded
    at ``n_components`` rows of ``X`` drawn from ``generator`` (with
    replacement when ``X`` has fewer rows)."""
    X = as_tensor_on(X)
    k0 = _init_indices(generator, X.shape[0], n_components, X.device)
    return _gmm_fit(X, k0, n_iter=n_iter, reg=reg)


def _stick_breaking_log_weights(nk, gamma0):
    """E[ln pi_k] under the truncated stick-breaking posterior
    (a_k = 1 + N_k, b_k = gamma + sum_{j>k} N_j; Blei & Jordan 2006 —
    sklearn's 'dirichlet_process' weight update)."""
    a = 1.0 + nk
    b = gamma0 + torch.flip(torch.cumsum(torch.flip(nk, [0]), 0), [0]) - nk
    dig_sum = torch.special.digamma(a + b)
    log_v = torch.special.digamma(a) - dig_sum
    log_1mv = torch.special.digamma(b) - dig_sum
    return log_v + torch.cat([torch.zeros_like(nk[:1]),
                              torch.cumsum(log_1mv, 0)[:-1]])


def _bgmm_fit(X, k0, n_iter: int = 500, reg: float = 1e-6,
              weight_concentration_prior: float | None = None) -> GMMModel:
    """The variational fit of :func:`bgmm_fit` from the hard assignment of
    every row to its nearest seed row ``X[k0]``: ``n_iter`` fixed VB steps."""
    n, d = X.shape
    K = k0.shape[0]
    gamma0 = (weight_concentration_prior
              if weight_concentration_prior is not None else 1.0 / K)
    beta0, nu0 = 1.0, float(d)
    m0 = X.mean(dim=0)
    Xc = X - m0
    eye = torch.eye(d, dtype=X.dtype, device=X.device)
    W0inv = (Xc.T @ Xc) / n + reg * eye
    iarange = torch.arange(1, d + 1, dtype=X.dtype, device=X.device)
    ln2, ln2pi = math.log(2.0), math.log(2.0 * math.pi)
    eps = 10 * torch.finfo(X.dtype).eps

    def posteriors(r):
        nk = r.sum(dim=0) + eps
        xbar = (r.T @ X) / nk[:, None]
        diff = X[:, None, :] - xbar[None, :, :]
        nk_sk = torch.einsum("nk,nki,nkj->kij", r, diff, diff)
        beta = beta0 + nk
        nu = nu0 + nk
        m = (beta0 * m0 + nk[:, None] * xbar) / beta[:, None]
        dm = xbar - m0
        w_inv = (W0inv[None] + nk_sk
                 + (beta0 * nk / beta)[:, None, None]
                 * torch.einsum("ki,kj->kij", dm, dm))
        return nk, beta, nu, m, w_inv

    def e_step(nk, beta, nu, m, w_inv):
        L = _cholesky(w_inv)                    # W^{-1} = L L^T
        lndet_winv = 2.0 * torch.sum(
            torch.log(torch.diagonal(L, dim1=-2, dim2=-1)), dim=-1)
        eln_lam = (torch.sum(torch.special.digamma(
            0.5 * (nu[:, None] + 1.0 - iarange)), dim=1)
            + d * ln2 - lndet_winv)
        maha = _maha(X, m, L)                   # (x-m)^T W (x-m)
        log_w = _stick_breaking_log_weights(nk, gamma0)
        logrho = (log_w[None, :] + 0.5 * eln_lam[None, :]
                  - 0.5 * d / beta[None, :] - 0.5 * nu[None, :] * maha
                  - 0.5 * d * ln2pi)
        return torch.exp(logrho - torch.logsumexp(logrho, dim=1,
                                                  keepdim=True))

    d2 = torch.sum((X[:, None, :] - X[k0][None, :, :]) ** 2, dim=-1)
    r = torch.nn.functional.one_hot(torch.argmin(d2, dim=1), K).to(X.dtype)
    for _ in range(n_iter):
        r = e_step(*posteriors(r))
    nk, beta, nu, m, w_inv = posteriors(r)
    v_a = 1.0 + nk
    v_b = gamma0 + torch.flip(torch.cumsum(torch.flip(nk, [0]), 0), [0]) - nk
    v = v_a / (v_a + v_b)
    w = v * torch.cat([torch.ones_like(v[:1]), torch.cumprod(1.0 - v, 0)[:-1]])
    w = w / w.sum()
    cov = (w_inv / torch.clamp(nu - d - 1.0, min=1e-3)[:, None, None]
           + reg * eye)
    return GMMModel(weights=w, means=m, chols=_cholesky(cov))


@_f32_matmuls
def bgmm_fit(generator: torch.Generator, X, n_components: int,
             n_iter: int = 500, reg: float = 1e-6,
             weight_concentration_prior: float | None = None) -> GMMModel:
    """Variational GMM with Dirichlet-process weights and Normal-Wishart
    component posteriors — the behaviour of sklearn's
    ``BayesianGaussianMixture`` the reference relies on
    (``GenerativeModel_AtmosInputs.py:30,401``): surplus components are
    driven to ~zero weight.

    Bishop PRML §10.2 with sklearn's default priors: stick-breaking
    concentration 1/K, mean precision beta0 = 1 at m0 = mean(X), Wishart dof
    nu0 = d with the empirical covariance as scale prior. Initialised by
    the hard assignment to ``n_components`` rows drawn from ``generator``
    (with replacement when ``X`` has fewer rows). Returns the variational
    expected weights (near zero for pruned components; :func:`gmm_prune`
    drops them) and the posterior-expected covariances W^-1/(nu - d - 1).
    """
    X = as_tensor_on(X)
    k0 = _init_indices(generator, X.shape[0], n_components, X.device)
    return _bgmm_fit(X, k0, n_iter=n_iter, reg=reg,
                     weight_concentration_prior=weight_concentration_prior)


def gmm_prune(model: GMMModel, threshold: float = 1e-3) -> GMMModel:
    """Drop components below a weight threshold (on the host, renormalized)."""
    w = model.weights.cpu().numpy()
    keep = np.nonzero(w > threshold)[0]
    if keep.size == 0:
        keep = np.array([int(w.argmax())])
    w_k = w[keep]
    keep_t = torch.as_tensor(keep, device=model.weights.device)
    return GMMModel(weights=as_tensor_on(w_k / w_k.sum(),
                                         model.weights.device),
                    means=model.means[keep_t], chols=model.chols[keep_t])


@_f32_matmuls
def gmm_log_prob(model: GMMModel, X):
    """Per-sample log density (sklearn ``score_samples``)."""
    X = as_tensor_on(X, model.means.device, model.means.dtype)
    logp = _log_gauss(X, model.means, model.chols)
    return torch.logsumexp(logp + torch.log(model.weights)[None, :], dim=1)


@_f32_matmuls
def gmm_predict(model: GMMModel, X):
    X = as_tensor_on(X, model.means.device, model.means.dtype)
    logp = _log_gauss(X, model.means, model.chols)
    return torch.argmax(logp + torch.log(model.weights)[None, :], dim=1)


@_f32_matmuls
def gmm_sample(generator: torch.Generator, model: GMMModel, n: int):
    """``n`` draws of the mixture: components by weight, then
    mean + chol @ standard normal."""
    gdev = generator.device
    comp = torch.multinomial(model.weights.to(gdev), n, replacement=True,
                             generator=generator)
    eps = torch.randn((n, model.means.shape[1]), generator=generator,
                      device=gdev, dtype=model.means.dtype)
    comp, eps = comp.to(model.means.device), eps.to(model.means.device)
    return model.means[comp] + torch.einsum("nij,nj->ni", model.chols[comp],
                                            eps)


# ---------------------------------------------------------------------------
# Atmospheric variable conversions (GenerativeModel_AtmosInputs.py:52-84)
# ---------------------------------------------------------------------------

_R_GAS = 8.314  # [J/K/mol]
_MIX2MASS = 18.0 / (0.8 * 28.0 + 0.2 * 32.0)  # vmr -> mass mixing ratio


def _like(a, ref):
    return as_tensor_on(a, ref.device, ref.dtype)


def mf2mol_cum(x, P, T):
    """Cumulative column moles (reference ``mf2mol_cum``, ``:61-66``)."""
    x = as_tensor_on(x)
    rho = (_like(P, x)[None, :] / _like(T, x)) / _R_GAS
    return torch.cumsum(rho * x, dim=1)


def mol_cum2mf(c, P, T):
    """Inverse of :func:`mf2mol_cum` with negativity clamps (``:68-77``)."""
    c = torch.clamp(as_tensor_on(c), min=0.0)
    c_diff = torch.clamp(torch.diff(c, dim=1), min=0.0)
    x = torch.cat([c[:, :1], c_diff], dim=1)
    rho = (_like(P, c)[None, :] / _like(T, c)) / _R_GAS
    return x / rho


def _saturation_vapor_pressure(T):
    """Bolton (1980) es(T) [Pa] (in place of the external ``atmos``
    package)."""
    Tc = T - 273.15
    return 611.2 * torch.exp(17.67 * Tc / (Tc + 243.5))


def mf2rh(P, T, mf):
    """Relative humidity [%] from H2O volume mixing fraction (``:52-59``)."""
    W = torch.clamp(as_tensor_on(mf), min=0.0)
    P = _like(P, W)
    # zero above the reference's pressure cutoff (101325 e^-3 Pa)
    W = torch.where(P[None, :] < 101325.0 * np.exp(-3.0),
                    torch.zeros_like(W), W)
    w_mass = W * _MIX2MASS
    e = w_mass * P[None, :] / (w_mass + 0.622)
    rh = 100.0 * e / _saturation_vapor_pressure(_like(T, W))
    return torch.where((rh < 0) | (W == 0), torch.zeros_like(rh), rh)


def rh_filter(P, T, H2O, rh_max: float = 96.0):
    """Boolean mask of profiles with no supersaturated layer (``:79-84``)."""
    return ~torch.any(mf2rh(P, T, H2O) > rh_max, dim=1)


# ---------------------------------------------------------------------------
# Feature transforms (GenerativeModel_AtmosInputs.py:90-206)
# ---------------------------------------------------------------------------

def _append_max3(w):
    return torch.cat([w, 3.0 * w.max()[None]])


def trans_T(T, P, Tm=None):
    T_ = as_tensor_on(T)
    if Tm is not None:
        T_ = T_ - _like(Tm, T_)[None, :]
    Tg = T_[:, 0]
    T_ = T_ - Tg[:, None]
    Tr = T_[:, 1:]
    Trm, Trs = Tr.mean(), _std(Tr)
    Tgm, Tgs = Tg.mean(), _std(Tg)
    Tg = (Tg - Tgm) / Tgs
    Tr = (Tr - Trm) / Trs
    w = _std(_like(P, Tr)[1:] * Tr, dim=0)
    w = _append_max3(w / w.sum())
    feats = torch.hstack([Tr, Tg[:, None]])
    return feats, (Tgm, Tgs, Trm, Trs), w


def itrans_T(feats, trans_vars, T=None, q: float = 0.1, Tm=None):
    Tgm, Tgs, Trm, Trs = trans_vars
    Tg = feats[:, -1] * Tgs + Tgm
    Tr = feats[:, :-1] * Trs + Trm + Tg[:, None]
    T_ = torch.hstack([Tg[:, None], Tr])
    if Tm is not None:
        T_ = T_ + _like(Tm, T_)[None, :]
    ok = torch.ones(T_.shape[0], dtype=torch.bool, device=T_.device)
    if T is not None:
        T = _like(T, T_)
        bad = (torch.any(T_ - (1 - q) * T.min(dim=0).values[None, :] < 0,
                         dim=1)
               | torch.any(T_ - (1 + q) * T.max(dim=0).values[None, :] > 0,
                           dim=1))
        bad = bad | torch.any(
            torch.abs(torch.diff(T_, dim=1))
            - (1 + q) * torch.abs(torch.diff(T, dim=1)).max(dim=0).values[
                None, :] > 0,
            dim=1)
        ok = ~bad
    return T_, ok


def trans_C(x, P, T):
    c = mf2mol_cum(x, P, T)
    cp = c[:, -1]
    pos_min = torch.min(torch.where(cp > 0, cp, torch.full_like(cp, math.inf)))
    cp = torch.where(cp == 0, pos_min, cp)
    cr = c[:, :-1] / cp[:, None]
    crm, crs = cr.mean(), _std(cr)
    cr = (cr - crm) / crs
    cpm, cps = cp.mean(), _std(cp)
    cpn = (cp - cpm) / cps
    w = _std(cr, dim=0)
    w = _append_max3(w / w.sum())
    feats = torch.hstack([cr, cpn[:, None]])
    return feats, (crm, crs, cpm, cps), w


def itrans_C(feats, trans_vars, P, T, c=None, q: float = 0.05):
    crm, crs, cpm, cps = trans_vars
    cp = feats[:, -1] * cps + cpm
    cr = feats[:, :-1] * crs + crm
    cu = torch.hstack([cr * cp[:, None], cp[:, None]])
    x_ = mol_cum2mf(cu, P, T)

    c_diff = torch.diff(cu, dim=1)
    # reference: np.percentile(np.abs(cu[cu>0]), 5), as a masked
    # nanquantile (NumPy's linear interpolation)
    c_sm = torch.nanquantile(
        torch.where(cu > 0, torch.abs(cu), torch.full_like(cu, math.nan)),
        0.05)
    c_diff_sm = torch.quantile(torch.abs(c_diff), 0.05)
    bad = (torch.any(cu < -c_sm, dim=1)
           | torch.any(c_diff < -c_diff_sm, dim=1)
           | (cu[:, -1] == 0))
    if c is not None:
        c = _like(c, cu)
        metric = ((cu - (1 - q) * c.min(dim=0).values[None, :] < 0)
                  | (cu - (1 + q) * c.max(dim=0).values[None, :] > 0))
        bad = bad | torch.any(metric, dim=1)
    return x_, ~bad


def atmos_to_features(P, T, H2O, O3, transform: bool = True, Tm=None):
    T = as_tensor_on(T)
    H2O, O3 = _like(H2O, T), _like(O3, T)
    ixT = np.arange(T.shape[1])
    ixH2O = 1 + ixT[-1] + np.arange(H2O.shape[1])
    ixO3 = 1 + ixH2O[-1] + np.arange(O3.shape[1])
    if transform:
        T_, vars_T, wT = trans_T(T, P, Tm=Tm)
        H2O_, vars_H2O, wH2O = trans_C(H2O, P, T)
        O3_, vars_O3, wO3 = trans_C(O3, P, T)
        trans_vars = (vars_T, ixT, vars_H2O, ixH2O, vars_O3, ixO3, Tm)
        wC = wH2O / wH2O.max() + wO3 / wO3.max()
        wC = wC / wC.sum()
        wT = wT * wC
        wT = wT / wT[:-1].sum()
        wT = torch.cat([wT[:-1], wT[:-1].max()[None]])
    else:
        T_, H2O_, O3_ = T, H2O, O3
        trans_vars = ((), ixT, (), ixH2O, (), ixO3, Tm)
        wT, wH2O, wO3 = (torch.ones(a.shape[1], dtype=T.dtype,
                                    device=T.device) for a in (T_, H2O_, O3_))
    X = torch.cat([T_, H2O_, O3_], dim=1)
    wX = torch.cat([wT / wT.max(), wH2O / wH2O.max(), wO3 / wO3.max()])
    return X, trans_vars, wX / wX.sum()


def features_to_atmos(X, trans_vars, P, T=None, cH2O=None, cO3=None):
    vars_T, ixT, vars_H2O, ixH2O, vars_O3, ixO3, Tm = trans_vars
    col = lambda ix: X[:, torch.as_tensor(ix, device=X.device)]  # noqa: E731
    T_, H2O_, O3_ = col(ixT), col(ixH2O), col(ixO3)
    okT = okW = okO = torch.ones(X.shape[0], dtype=torch.bool,
                                 device=X.device)
    if len(vars_T) > 0:
        T_, okT = itrans_T(T_, vars_T, T, Tm=Tm)
    if len(vars_H2O) > 0:
        H2O_, okW = itrans_C(H2O_, vars_H2O, P, T_, cH2O)
    if len(vars_O3) > 0:
        O3_, okO = itrans_C(O3_, vars_O3, P, T_, cO3)
    return T_, H2O_, O3_, okT & okW & okO


# ---------------------------------------------------------------------------
# Generator + air-mass machinery (GenerativeModel_AtmosInputs.py:212-443)
# ---------------------------------------------------------------------------

def atmos_generator(generator: torch.Generator, P, T, H2O, O3,
                    n_pca: int = 15, n_gmm: int = 20, transform: bool = True,
                    weight: bool = True, filt: bool = True,
                    rh_max: float = 96.0, variational: bool = True):
    """Fit the PCA+GMM model; return (sample_fn, diagnostics).

    ``sample_fn(generator, n)`` draws 5n candidates, applies the
    plausibility and RH rejections, and returns up to n surviving
    (T, H2O, O3) profiles and their model log-likelihoods as NumPy arrays
    (reference ``atm_gen``, ``:225-242``). ``variational=True`` fits
    :func:`bgmm_fit` (the reference's ``BayesianGaussianMixture``),
    ``False`` plain EM (:func:`gmm_fit`), both seeded from ``generator``.
    """
    T = as_tensor_on(T)
    P, H2O, O3 = (_like(a, T) for a in (P, H2O, O3))
    X, trans_vars, wX = atmos_to_features(P, T, H2O, O3, transform=transform,
                                          Tm=T.mean(dim=0))
    cH2O = mf2mol_cum(H2O, P, T)
    cO3 = mf2mol_cum(O3, P, T)

    w = wX if weight else torch.ones_like(wX)
    w_pos_min = torch.min(torch.where(w > 0, w, torch.full_like(w, math.inf)))
    w = torch.where(w == 0, w_pos_min / 100.0, w)
    pca = pca_fit(X * w[None, :], n_pca)
    Xr = pca.transform(X * w[None, :])
    gmm = (bgmm_fit if variational else gmm_fit)(generator, Xr, n_gmm)
    Xm = pca.inverse_transform(Xr) / w[None, :]

    def sample_fn(gen, n: int):
        Zr = gmm_sample(gen, gmm, int(5 * n))
        ll = gmm_log_prob(gmm, Zr)
        Xn = pca.inverse_transform(Zr) / w[None, :]
        T_n, H_n, O_n, ok = features_to_atmos(Xn, trans_vars, P, T=T,
                                              cH2O=cH2O, cO3=cO3)
        ok = ok & rh_filter(P, T_n, H_n, rh_max=rh_max)
        if filt:
            keep = np.nonzero(ok.cpu().numpy())[0][:n]
        else:
            keep = np.arange(min(n, T_n.shape[0]))
        return tuple(a.cpu().numpy()[keep] for a in (T_n, H_n, O_n, ll))

    return sample_fn, dict(X=X, Xr=Xr, Xm=Xm, trans_vars=trans_vars, wX=wX,
                           pca=pca, gmm=gmm)


def _airmass_features(z, P, T, H2O, O3):
    """(n, 4) standardized (T_surf, lapse, total H2O, total O3)."""
    T = as_tensor_on(T)
    z = _like(z, T)
    H2O, O3 = _like(H2O, T), _like(O3, T)
    cH2O = mf2mol_cum(H2O, P, T)
    cO3 = mf2mol_cum(O3, P, T)
    T_surf = T[:, z < 3].mean(dim=1)
    T_grad = torch.diff(T[:, z < 6], dim=1).mean(dim=1)
    f = lambda x: (x - x.mean()) / _std(x)  # noqa: E731
    return torch.stack([f(T_surf), f(T_grad), f(cH2O[:, -1]),
                        f(cO3[:, -1])], dim=1)


def airmass_labels(generator: torch.Generator, z, P, T, H2O, O3,
                   n_airmass: int = 5, variational: bool = True):
    """Cluster profiles into air masses on (T_surf, lapse, total H2O, total
    O3) features (reference ``airmass_labels``, ``:391-419``; a BGM fit,
    ``:401``, so surplus air-mass slots prune themselves); NumPy labels."""
    feats = _airmass_features(z, P, T, H2O, O3)
    fit = bgmm_fit if variational else gmm_fit
    gmm = fit(generator, feats, n_airmass, n_iter=300)
    return gmm_predict(gmm, feats).cpu().numpy()


def gen_samples_per_airmass(generator: torch.Generator, z, P, T, H2O, O3,
                            labels, n_pca: int = 15, n_gmm: int = 10,
                            n_aug: int = 100):
    """Per-air-mass model fit and n_aug-fold augmentation (``:421-443``):
    NumPy arrays T, H2O, O3 (n_gen, nL), labels and ll (n_gen,)."""
    T = as_tensor_on(T)
    P, H2O, O3 = (_like(a, T) for a in (P, H2O, O3))
    labels = np.asarray(labels)
    outs = {k: [] for k in ("T", "H2O", "O3", "labels", "ll")}
    for lab in np.unique(labels):
        ix = torch.as_tensor(labels == lab, device=T.device)
        n_ix = int((labels == lab).sum())
        sample_fn, _ = atmos_generator(generator, P, T[ix], H2O[ix], O3[ix],
                                       n_pca=min(n_pca, n_ix - 1),
                                       n_gmm=min(n_gmm, n_ix))
        T_n, H_n, O_n, ll = sample_fn(generator, int(n_aug * n_ix))
        outs["T"].append(T_n)
        outs["H2O"].append(H_n)
        outs["O3"].append(O_n)
        outs["labels"].append(np.full(T_n.shape[0], lab))
        outs["ll"].append(ll)
    return {k: np.concatenate(v) for k, v in outs.items()}
