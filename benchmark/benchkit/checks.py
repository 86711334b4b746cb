"""The comparisons that decide ``correct``, shared by the drivers.

A served TUD member is checked at reduced outputs drawn from the seed: the
reference computes every fine point each output reads (the reduction's
support), composes tau, Lu and Ld there and reduces them, all in its own
code. Three numbers are compared, over every checked member and output:
the largest |tau - tau_ref| (tau is a fraction), and the largest
|Lu - Lu_ref| and |Ld - Ld_ref| each over the largest |Lu_ref| or
|Ld_ref| checked (a share of the peak).
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.radiative import Reduction, compose


def outputs(rng: np.random.Generator, n_out: int, k: int) -> np.ndarray:
    """``k`` distinct reduced outputs, in order."""
    return np.sort(rng.choice(n_out, size=min(k, n_out), replace=False))


def member_reference(red: Reduction, idx, X: np.ndarray, od_at,
                     T: np.ndarray, z0, altitudes, n_angles: int, dtype,
                     device):
    """Reference (tau (k, nZ), Lu (k, nZ), Ld (k,)) at reduced outputs
    ``idx`` of one member: ``od_at(points (P,), lo)`` the (nL, P) layer OD
    at the fine points from index ``lo``."""
    taus, lus, lds = [], [], []
    Tt = torch.as_tensor(T, dtype=torch.float64, device=device)
    for i in idx:
        lo, hi = red.support(int(i))
        pts = X[lo:hi]
        od = od_at(pts, lo)
        nu = torch.as_tensor(pts, dtype=torch.float64, device=device)
        tau, Lu, Ld = compose(od.to(dtype), nu, Tt, z0, altitudes, n_angles)
        taus.append(red.apply(int(i), tau, lo))
        lus.append(red.apply(int(i), Lu, lo))
        lds.append(red.apply(int(i), Ld, lo))
    f = lambda a: torch.stack(a).double().cpu().numpy()  # noqa: E731
    return f(taus), f(lus), f(lds)


def compare(prog: list, ref: list) -> list:
    """[(name, value)] over members: prog and ref lists of (tau, Lu, Ld)."""
    t = max(float(np.abs(p[0] - r[0]).max()) for p, r in zip(prog, ref))
    lu_pk = max(float(np.abs(r[1]).max()) for r in ref)
    ld_pk = max(float(np.abs(r[2]).max()) for r in ref)
    lu = max(float(np.abs(p[1] - r[1]).max()) for p, r in zip(prog, ref))
    ld = max(float(np.abs(p[2] - r[2]).max()) for p, r in zip(prog, ref))
    bad = not all(np.isfinite(p[k]).all() for p in prog for k in range(3))
    inf = float("inf")
    return [("tau_abs", inf if bad else t),
            ("lu_of_peak", inf if bad else lu / lu_pk),
            ("ld_of_peak", inf if bad else ld / ld_pk)]


def with_limits(values: list, limits: dict) -> list:
    """[(name, value, limit)], each limit from the traffic mix."""
    return [(n, v, float(limits[n])) for n, v in values]
