"""Plain reference of the TUD composition, the reduction to the output
resolution, and the table lookup of the serving path.

* Composition (``radiative_transfer.py`` of the reference, the plane-
  parallel layer recursion): tau at each sensor altitude exp(-sum of the
  layers below it), upwelling Lu by Lu <- t Lu + (1 - t) B layer by layer
  from the ground, downwelling Ld by the same recursion from the top at
  each of n_angles zenith angles theta uniform on [0, pi/2) (endpoint
  excluded) and averaged with weights cos(theta) sin(theta), normalised;
  B the Planck radiance c1 1e4 nu^3 / expm1(c2 nu / T), nu in 1/m.
* Reduction (``reduceResolution``): a symmetric Hanning smooth of
  round(dX / dx) points, 0.5 (smooth(y) + reverse(smooth(reverse(y)))),
  then 4-point Lagrange interpolation onto linspace(x_s[m], x_s[-m-1],
  ceil(N (x_s[-m-1] - x_s[m]) / dX) + 1), with N = 4 and x_s the smoothed
  axis; here evaluated at interior outputs only, from the fine points each
  one needs.
* Table lookup: sigma(T, p) bilinear in (T, log p), clamped to the
  lattice, times each species' column.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .lbl import BARYE_PER_ATM, CM_PER_KM, K_B_CGS, PA_PER_ATM

C1 = 1.19104295315e-16     # 2 h c^2 [J m^2 / s]
C2 = 1.43877736830e-02     # h c / k [m K]


def compose(od: torch.Tensor, nu: torch.Tensor, T: torch.Tensor,
            z0: np.ndarray, altitudes, n_angles: int = 30):
    """tau (nZ, P), Lu (nZ, P), Ld (P,) of layer ODs ``od`` (nL, P) at
    wavenumbers ``nu`` (P,) [cm^-1], layer temperatures ``T`` (nL,), layer
    bottoms ``z0`` [km] and sensor ``altitudes`` [km], in od's dtype."""
    dt = od.dtype
    n_lay = od.shape[0]
    n_below = [(np.asarray(z0) <= a).sum() for a in altitudes]
    x = nu.to(dt) * 100.0
    B = (C1 * 1e4) * x ** 3 / torch.expm1(C2 * x[None, :] / T.to(dt)[:, None])
    t = torch.exp(-od)
    lu = torch.zeros_like(od[0])
    cum = torch.zeros_like(od[0])
    tau, Lu = [None] * len(altitudes), [None] * len(altitudes)
    for zi, n in enumerate(n_below):
        if n == 0:
            tau[zi], Lu[zi] = torch.ones_like(cum), torch.zeros_like(cum)
    for k in range(n_lay):
        lu = t[k] * lu + (1.0 - t[k]) * B[k]
        cum = cum + od[k]
        for zi, n in enumerate(n_below):
            if n == k + 1:
                tau[zi], Lu[zi] = torch.exp(-cum), lu
    th = np.linspace(0.0, np.pi / 2.0, n_angles, endpoint=False)
    w = np.cos(th) * np.sin(th)
    w = torch.as_tensor(w / w.sum(), dtype=dt, device=od.device)
    sec = torch.as_tensor(1.0 / np.cos(th), dtype=dt, device=od.device)
    ld = torch.zeros((n_angles, od.shape[1]), dtype=dt, device=od.device)
    for k in range(n_lay - 1, -1, -1):
        ta = torch.exp(-od[k][None, :] * sec[:, None])
        ld = ta * ld + (1.0 - ta) * B[k][None, :]
    return torch.stack(tau), torch.stack(Lu), (ld * w[:, None]).sum(dim=0)


class Reduction:
    """``reduceResolution(X, ., dX, N=4, 'hanning')`` on the uniform axis
    ``X``, at interior outputs: the output axis and each output's stencil
    from the smoothed axis exactly as the reference's host code forms them
    (``np.convolve`` of the reflected axis), the smoothed values from the
    fine points each output reads."""

    def __init__(self, X: np.ndarray, dX: float, N: int = 4):
        X = np.asarray(X, np.float64)
        self.n = X.size
        self.m = int(round(dX / float(np.mean(np.diff(X)))))
        h = np.hanning(self.m)
        self.h = h / h.sum()
        self.x_s = self._sym_smooth(X)
        m = self.m
        self.n_out = int(np.ceil(N * (self.x_s[-m - 1] - self.x_s[m])
                                 / dX)) + 1
        self.x_out = np.linspace(self.x_s[m], self.x_s[-m - 1], self.n_out)

    def _sym_smooth(self, v):
        """0.5 (smooth(v) + reverse(smooth(reverse(v)))), ``smooth`` the
        reference's reflected-edge window convolution."""
        m, w = self.m, self.h

        def one(a):
            s = np.r_[a[m - 1:0:-1], a, a[-2:-m - 1:-1]]
            y = np.convolve(w, s, mode="valid")
            return y[int(np.ceil(m / 2 - 1)): y.size - int(np.floor(m / 2))]

        return 0.5 * (one(v) + one(v[::-1])[::-1])

    def _smooth_taps(self):
        """Offsets and weights of one interior smoothed value: with
        a = ceil(m/2 - 1) the forward pass's window covers k + a - j, the
        reverse one's k - a + j (j = 0..m-1), each taken with half
        weight."""
        a = int(math.ceil(self.m / 2 - 1))
        j = np.arange(self.m)
        return (np.concatenate([a - j, -a + j]),
                0.5 * np.concatenate([self.h, self.h]))

    def stencil(self, i: int):
        """(fine indices (4,), Lagrange weights (4,)) of output ``i``."""
        xo = self.x_out[i]
        j = int(np.searchsorted(self.x_s, xo, side="right")) - 1
        nodes = np.clip(j - 1, 0, self.n - 4) + np.arange(4)
        xn = self.x_s[nodes]
        w = np.ones(4)
        for a in range(4):
            for b in range(4):
                if a != b:
                    w[a] *= (xo - xn[b]) / (xn[a] - xn[b])
        return nodes, w

    def support(self, i: int) -> tuple[int, int]:
        """[lo, hi) of the fine points output ``i`` reads."""
        nodes, _ = self.stencil(i)
        off, _ = self._smooth_taps()
        return int(nodes[0] + off.min()), int(nodes[-1] + off.max()) + 1

    def apply(self, i: int, y: torch.Tensor, lo: int) -> torch.Tensor:
        """Output ``i`` of fine values ``y`` (..., P) that start at fine
        index ``lo``."""
        nodes, w = self.stencil(i)
        off, ws = self._smooth_taps()
        idx = torch.as_tensor(nodes[:, None] + off[None, :] - lo,
                              device=y.device)
        wt = torch.as_tensor(w[:, None] * ws[None, :], dtype=y.dtype,
                             device=y.device)
        return (y[..., idx] * wt).sum(dim=(-1, -2))


def species_column(p_pa, T, pl_km, vmr):
    """Column density [molec/cm^2] of each species of homogeneous layers."""
    n_tot = (np.asarray(p_pa, np.float64) / PA_PER_ATM * BARYE_PER_ATM
             / (K_B_CGS * np.asarray(T, np.float64)))
    return vmr * (n_tot * np.asarray(pl_km, np.float64) * CM_PER_KM)[:, None]


def table_od(sigma_pts: torch.Tensor, T_grid, logp_grid, T, p_pa, pl_km,
             vmr_cols: np.ndarray) -> torch.Tensor:
    """(nL, P) OD from a cross-section table at P points, ``sigma_pts``
    (nM, nT, nP, P) in the reference's dtype: per layer and species the
    bilinear (T, log p) corner weights, clamped at the lattice's edges,
    times the species column ``vmr_cols`` (nL, nM)."""
    T_grid = np.asarray(T_grid, np.float64)
    logp_grid = np.asarray(logp_grid, np.float64)

    def bracket(grid, v):
        i = np.clip(np.searchsorted(grid, v, side="right") - 1, 0,
                    grid.size - 2)
        return i, np.clip((v - grid[i]) / (grid[i + 1] - grid[i]), 0.0, 1.0)

    T = np.asarray(T, np.float64)
    it, ft = bracket(T_grid, T)
    ip, fp = bracket(logp_grid, np.log(np.asarray(p_pa, np.float64)
                                       / PA_PER_ATM))
    col = species_column(p_pa, T, pl_km, vmr_cols)
    dt = sigma_pts.dtype
    out = []
    for l in range(T.size):
        acc = 0.0
        for di, dj, c in ((0, 0, (1 - ft[l]) * (1 - fp[l])),
                          (0, 1, (1 - ft[l]) * fp[l]),
                          (1, 0, ft[l] * (1 - fp[l])), (1, 1, ft[l] * fp[l])):
            s = sigma_pts[:, it[l] + di, ip[l] + dj]            # (nM, P)
            acc = acc + (torch.as_tensor(col[l] * c, dtype=dt,
                                         device=s.device)[:, None] * s).sum(0)
        out.append(acc)
    return torch.stack(out)
