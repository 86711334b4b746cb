"""The CO2 Q-branch line-mixing rule, frozen: the first-order (Rosenkranz)
coefficients y_air of the ``lwir_tud_prod`` configuration's derived list,
a column of the line data that the benchmark hands to the program and to
the reference alike.

A copy of ``radtxfr_tpu_torch/kernels/linemixing_data.py:67-204`` (the
energy-gap relaxation matrix per branch, detailed balance, the regularised
first-order kernel and its exact S-weighted sum rule; see that module's
docstring for the derivation), with ``y_air_for_store`` taking the sorted
centres instead of a line store.
"""

from __future__ import annotations

import numpy as np

from .derived_lines import C2_CM_K, T_REF, co2_lwir_lines

EPG_A2 = 0.75   #: power-gap exponent (CO2-air magnitude)
EPG_A3 = 0.30   #: exponential-gap factor
_B0 = 0.39021894


def _branch_w_matrix(nu, el, sw, gamma, T):
    """(W, rho, d) for one branch family: EPG + detailed balance,
    amplitude calibrated to the line widths (see module docstring)."""
    n = nu.size
    rho = np.exp(-C2_CM_K * (el - el.min()) / T)
    # reduced dipole amplitudes from HITRAN intensities: S ~ rho d^2
    # (radiation/stimulated factors vary slowly across one branch)
    d = np.sqrt(np.maximum(sw, 1e-300) / rho)
    dE = np.abs(el[:, None] - el[None, :])
    with np.errstate(divide="ignore"):
        shape = (dE / _B0) ** (-EPG_A2) * np.exp(-EPG_A3 * C2_CM_K * dE / T)
    np.fill_diagonal(shape, 0.0)
    # downward rates (to lower-energy lines) carry the EPG shape; upward
    # from detailed balance rho_k R(j<-k) = rho_j R(k<-j). R[j, k] is the
    # k -> j transfer rate; exactly-degenerate pairs stay uncoupled.
    mask_down = el[:, None] < el[None, :]
    Rd = shape * mask_down
    Ru = (Rd * rho[None, :]).T / rho[None, :]
    R = Rd + Ru
    # calibrate: out-rate sum ~ gamma (median over the branch) — the
    # state-changing share of the width in LINE space. This keeps
    # W = diag(gamma) - R diagonally dominant (positive semidefinite up
    # to the population-conserving ~zero mode), so the resolvent profile
    # stays loss-only (out-sum = 2*gamma flips W eigenvalues negative and
    # produces unphysical gain lobes; measured).
    out_rate = R.sum(axis=0)
    # min over the branch (not median): a single over-budget column makes
    # an eigenvalue of W negative -> gain lobes in the resolvent profile
    # and a broken area integral. A uniform scale preserves detailed
    # balance (pair ratios), which per-column clipping would not.
    scale = 0.98 * np.min(gamma / np.maximum(out_rate, 1e-300))
    R = R * scale
    W = -R                                  # off-diagonal relaxation matrix
    np.fill_diagonal(W, gamma)
    return W, rho, d


def _first_order_y(nu, W, d, gamma=None):
    """Rosenkranz first-order coefficients from (W, d) [1/atm].

    The bare expansion kernel ``1/(nu_k - nu_j)`` diverges for the
    near-degenerate pairs a CO2 Q-branch head piles up (measured |Y| up to
    ~200/atm on the 720.8 branch — far outside the first-order validity
    domain |Y p| << 1, and enough to drive whole-layer OD negative next to
    the branch, round-5 full-res finding). Those pairs are exactly where
    the perturbation series in ``p W / dnu`` breaks: once the gap is
    inside the blended width the lines mix to all orders and the
    dispersive first-order term saturates instead of diverging. The
    regularized antisymmetric kernel

        f(dnu) = dnu / (dnu^2 + delta_jk^2),  delta_jk = gamma_j + gamma_k

    (the 1-atm blend scale, since Y is the 1-atm-referenced coefficient)
    bounds every pair by ``W_jk / (2 delta)`` while preserving the EXACT
    S-weighted sum rule: the pair (j,k) contribution to sum_k S_k Y_k is
    ``rho_k W_jk d_j d_k (f(dnu_kj) + f(dnu_jk))``, zero for ANY odd f by
    detailed balance — the same cancellation the bare kernel relied on.
    Far pairs (|dnu| >> delta) are untouched, so the p -> 0 convergence
    to the full-W resolvent is preserved (tests/test_derived.py).
    """
    n = nu.size
    dnu = nu[:, None] - nu[None, :]
    if gamma is None:
        kern = np.zeros_like(dnu)
        np.divide(1.0, dnu, out=kern, where=dnu != 0.0)
    else:
        delta = gamma[:, None] + gamma[None, :]
        kern = dnu / (dnu * dnu + delta * delta)
    terms = (d[None, :] / d[:, None]) * W.T * kern  # [k, j] = d_j/d_k W_jk f
    np.fill_diagonal(terms, 0.0)
    return 2.0 * np.nansum(terms, axis=1)


def co2_q_branch_y(T: float = T_REF, min_lines: int = 4,
                   include_pr: bool = False):
    """Derive first-order y_air for the LWIR CO2 branches.

    Returns ``(nu0, y_air, meta)``: line centers, coefficients [1/atm at
    ``T``], and a list of (band, dJ, slice) describing each coupled
    family. Only Q branches by default (``include_pr=True`` adds the P/R
    combs, whose within-branch spacings make mixing tiny)."""
    rows = co2_lwir_lines()
    nu = rows["nu0"]
    out_nu, out_y, meta = [], [], []
    branches = (-1, 0, 1) if include_pr else (0,)
    for band in np.unique(rows["band"]):
        for dj in branches:
            m = (rows["band"] == band) & (rows["dJ"] == dj)
            if m.sum() < min_lines:
                continue
            nu_b = nu[m]
            W, rho, d = _branch_w_matrix(
                nu_b, rows["elower"][m], rows["sw"][m],
                rows["gamma_air"][m], T)
            y = _first_order_y(nu_b, W, d, gamma=rows["gamma_air"][m])
            # exactness check of the S-weighted sum rule (detailed
            # balance makes it pairwise-antisymmetric; guard float noise)
            s = rows["sw"][m]
            resid = abs(float(np.sum(s * y))) / max(
                float(np.sum(s * np.abs(y))), 1e-300)
            if resid > 1e-8:
                raise AssertionError(
                    f"sum rule violated for {band} dJ={dj}: {resid}")
            out_nu.append(nu_b)
            out_y.append(y)
            meta.append((str(band), int(dj), int(m.sum())))
    if not out_nu:
        return np.empty(0), np.empty(0), []
    nu_all = np.concatenate(out_nu)
    y_all = np.concatenate(out_y)
    order = np.argsort(nu_all, kind="stable")
    return nu_all[order], y_all[order], meta


def y_air_for_centres(nu_s, T: float = T_REF, **kw):
    """Full-length ``y_air`` aligned with the sorted float64 line centres
    ``nu_s`` (zeros for non-CO2 / non-branch lines), matched by line-centre
    identity."""
    nu_q, y_q, _ = co2_q_branch_y(T=T, **kw)
    nu_s = np.asarray(nu_s, np.float64)
    y = np.zeros(nu_s.size)
    idx = np.searchsorted(nu_s, nu_q)
    for i, (k, yv) in enumerate(zip(idx, y_q)):
        for cand in (k - 1, k, k + 1):
            if 0 <= cand < nu_s.size and abs(nu_s[cand] - nu_q[i]) < 1e-9:
                y[cand] = yv
                break
    return y
