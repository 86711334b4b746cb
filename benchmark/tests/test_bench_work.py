"""The frozen work counts against work counted by hand on tiny inputs."""

from __future__ import annotations

import math

import numpy as np
import pytest

from bench_tiny import ROOT  # noqa: F401  (puts the benchmark on sys.path)
from benchkit import work
from benchkit.reference import lbl


def _params(nu0, wing, gd, g0, shift, g2=None):
    shape = np.asarray(wing).shape
    b = lambda a: np.broadcast_to(np.asarray(a, np.float64), shape)  # noqa
    return lbl.Params(nu0=b(nu0), strength=b(1.0), gamma_d=b(gd),
                      gamma_0=b(g0), shift=b(shift),
                      gamma_2=b(0.0 if g2 is None else g2), wing=b(wing),
                      Y=b(0.0))


def _by_hand_voigt(prm, x0, dx, n, mix):
    g = x0 + dx * np.arange(n)
    ops = 0
    live = 0
    for l in range(prm.nu0.shape[0]):
        for i in range(prm.nu0.shape[1]):
            nu0, w = prm.nu0[l, i], prm.wing[l, i]
            r = 15.0 * prm.gamma_d[l, i] / math.sqrt(math.log(2.0)) \
                - prm.gamma_0[l, i]
            c = nu0 + prm.shift[l, i]
            k_in = k_out = 0
            for x in g:
                if nu0 - w < x <= nu0 + w:
                    if abs(x - c) < r:
                        k_in += 1
                    else:
                        k_out += 1
            cin, cout = ((173, 36) if mix[i] else (157, 28))
            ops += k_in * cin + k_out * cout
            live += (k_in + k_out > 0) * (6 if mix[i] else 5)
    return ops, 4 * (live + prm.nu0.shape[0] * n)


@pytest.mark.parametrize("case", range(4))
def test_voigt_counts_match_hand_counts(case):
    rng = np.random.default_rng(case)
    nu0 = np.array([[1000.013, 1000.05, 999.97, 1000.2]] * 2)
    wing = rng.uniform(0.001, 0.08, nu0.shape)
    gd = rng.uniform(0.0005, 0.003, nu0.shape)
    g0 = rng.uniform(0.0001, 0.02, nu0.shape)
    shift = rng.normal(0.0, 0.002, nu0.shape)
    prm = _params(nu0, wing, gd, g0, shift)
    mix = np.array([False, True, False, False])
    ops, nbytes = work.voigt_od_work(prm, 1000.0, 0.0005, 200, mix)
    h_ops, h_bytes = _by_hand_voigt(prm, 1000.0, 0.0005, 200, mix)
    assert ops == h_ops and nbytes == h_bytes


def test_tangent_counts_match_hand_counts():
    rng = np.random.default_rng(7)
    nu0 = np.array([[1000.013, 1000.05, 999.97, 1000.2]] * 3)
    prm = _params(nu0, rng.uniform(0.001, 0.08, nu0.shape),
                  rng.uniform(0.0005, 0.003, nu0.shape),
                  rng.uniform(0.0001, 0.02, nu0.shape),
                  rng.normal(0.0, 0.002, nu0.shape))
    x0, dx, n = 1000.0, 0.0005, 200
    live = np.zeros((2,) + nu0.shape, bool)
    live[0, 1] = True                       # every line of layer 1
    live[1, 1, [0, 2]] = True               # two lines of layer 1
    ops, nbytes = work.voigt_tangent_work(prm, x0, dx, n, live)
    g = x0 + dx * np.arange(n)
    want = 0
    for i in range(4):
        w, c = prm.wing[1, i], prm.nu0[1, i] + prm.shift[1, i]
        r = 15.0 * prm.gamma_d[1, i] / math.sqrt(math.log(2.0)) \
            - prm.gamma_0[1, i]
        k_in = k_out = 0
        for x in g:
            if prm.nu0[1, i] - w < x <= prm.nu0[1, i] + w:
                k_in += abs(x - c) < r
                k_out += abs(x - c) >= r
        n_dirs = 1 + (i in (0, 2))
        want += (k_in * (48 + 16 * 16) + k_out * 54
                 + 8 * n_dirs * (k_in + k_out))
    assert ops == want
    assert nbytes == 4 * (5 * 4 + 4 * 6 + 2 * n)


def test_sd_lattice_counts_match_hand_counts():
    nu0 = np.array([[1000.3, 1001.0]])
    prm = _params(nu0, [[0.9, 0.2]], 0.002, 0.07, 0.001, g2=0.007)
    x0, dx, n = 1000.0, 0.0025, 1000
    ops, nbytes = work.sd_lattice_work(prm, x0, dx, n)
    R = work.COARSE_R
    h = max(work.NEAR_WIDTH, 41.0 * R * dx)
    gc = x0 - R * dx + R * dx * np.arange((n - 1) // R + 4)
    g = x0 + dx * np.arange(n)
    c = 0.002 / (2.0 * math.sqrt(math.log(2.0)) * 0.007)
    rad = 0.007 * (2 * c * c + 30 * c + 225) + 0.001
    want = 0
    for nu, w in ((1000.3, 0.9), (1001.0, 0.2)):
        far = ((gc > nu - w) & (gc <= nu + w)).sum()
        near = ((g > nu - h) & (g <= nu + h)).sum()
        core = ((g > nu - rad) & (g < nu + rad)).sum()
        want += (far * work.SD_FAR + near * (work.SD_FAR + work.INTERP_OPS)
                 + core * (work.SD_CORE + 2 * work.SD_ASYM))
    assert ops == want
    assert nbytes == 4 * (6 * 2 + n)


def test_k2_and_table_counts():
    ops, nbytes, sfu = work.k2_work(10, 3, 2, 1, 30)
    assert sfu == 10 * (3 * (1 + 30 + 2) + 2)
    assert ops == 10 * 3 * (28 + 31 * 3)
    assert nbytes == 4 * 3 * 10 + 4 * 13 + 4 * 10 * 5
    flop, nb = work.table_od_work(66, 100, 1000)
    assert flop == 2 * 66 * 100 * 1000
    assert nb == 4 * (100 * 1000 + 66 * 100 + 66 * 1000)


def test_bound_names_what_bounds_it():
    t, by = work.bound(67e12, 1.0)
    assert by == "operations" and t == pytest.approx(1.0)
    t, by = work.bound(1.0, 3.35e12)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = work.bound(0.0, 0.0, work.SFU_OPS_PER_S)
    assert by == "operations" and t == pytest.approx(1.0)
