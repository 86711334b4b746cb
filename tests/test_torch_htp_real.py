"""The Hartmann-Tran building blocks of the port (``kernels/htp_real.py``,
``kernels/ht_driver.py``) against radtxfr_tpu's, in float64.

The same NumPy inputs go to both packages. ``ht_line_constants`` and
``pcqsdhc_real`` run the same operations in the same order, so they agree
to rounding: within 1e-12 of peak over ``tests/test_htp_real.py``'s seven
region cases and its wide-span sweep (PART1's |Z1| > 4e3 branch, PART4's
CPF3 sub-case). The column resolution is host NumPy on both sides and is
held exactly; the (T, p) scaling within 1e-12 relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.kernels import ht_driver as j_drv
from radtxfr_tpu.kernels.faddeeva import weideman_coeffs as j_wei
from radtxfr_tpu.kernels.htp_real import ht_line_constants as j_consts
from radtxfr_tpu.kernels.htp_real import pcqsdhc_real as j_pcqsdhc
from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic
from radtxfr_tpu_torch.kernels import ht_driver
from radtxfr_tpu_torch.kernels.faddeeva import weideman_coeffs
from radtxfr_tpu_torch.kernels.htp_real import (HT_CONST_KEYS,
                                                ht_line_constants,
                                                pcqsdhc_real)
from radtxfr_tpu_torch.lines.store import IsoTables
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
from port_fixtures import one_torch_thread  # noqa: F401

F64 = dict(device="cpu", dtype=torch.float64)
#: the region cases of tests/test_htp_real.py:27-36:
#: (gamma2, shift2, nuvc, eta)
CASES = [
    ("sdvoigt-like", 0.008, 0.0, 0.0, 0.0 + 0.0j),
    ("sd-shift", 0.008, 5e-4, 0.0, 0.0 + 0.0j),
    ("rautian", 0.0, 0.0, 0.02, 0.0 + 0.0j),
    ("sd-rautian", 0.01, 3e-4, 0.03, 0.0 + 0.0j),
    ("full-ht-real-eta", 0.012, 4e-4, 0.015, 0.2 + 0.0j),
    ("full-ht-complex-eta", 0.012, 4e-4, 0.015, 0.18 + 0.04j),
    ("part1-voigt", 0.0, 0.0, 0.0, 0.0 + 0.0j),
]


def _both(gd, g0, g2, s0, s2, nuvc, eta, sg, sg0=1000.0, n_wei=24):
    """pcqsdhc_real through both packages on the same constants' inputs:
    (port, JAX) values (nLines, nPoints) and (port, JAX) constants."""
    cols = [np.atleast_1d(np.asarray(a, dtype=np.float64)) for a in
            (gd, g0, g2, s0, s2, nuvc, np.real(eta), np.imag(eta))]
    k = ht_line_constants(*(torch.as_tensor(a) for a in cols))
    jk = j_consts(*(jnp.asarray(a) for a in cols))
    dnu = np.asarray(sg, dtype=np.float64)[None, :] - sg0
    L, a = weideman_coeffs(n_wei)
    got = pcqsdhc_real(torch.as_tensor(dnu),
                       {key: v[:, None] for key, v in k.items()}, a, L)
    jL, ja = j_wei(n_wei)
    want = j_pcqsdhc(jnp.asarray(dnu),
                     {key: jnp.asarray(v)[:, None] for key, v in jk.items()},
                     tuple(float(c) for c in ja), float(jL))
    return got.numpy(), np.asarray(want), k, jk


@pytest.mark.parametrize("name,g2,s2,nuvc,eta", CASES)
def test_pcqsdhc_real_matches_jax(name, g2, s2, nuvc, eta):
    got, want, k, jk = _both(0.003, 0.07, g2, -0.008, s2, nuvc, eta,
                             np.linspace(999.0, 1001.0, 801))
    for key in HT_CONST_KEYS:
        b = np.asarray(jk[key])
        assert np.abs(k[key].numpy() - b).max() <= 1e-14 * max(
            np.abs(b).max(), 1e-300), key
    peak = np.abs(want).max()
    assert peak > 0.0
    assert np.abs(got - want).max() <= 1e-12 * peak, \
        (name, np.abs(got - want).max() / peak)


def test_pcqsdhc_real_wide_span_matches_jax():
    """The far wing (PART1's |Z1| > 4e3 branch, PART4's CPF3 sub-case) and
    a Doppler-dominated line near the small-Y regions, three parameter
    sets at once (tests/test_htp_real.py:53-67)."""
    sg = np.concatenate([np.linspace(600.0, 1400.0, 1601),
                         np.linspace(999.9, 1000.1, 801)])
    gd, g0, g2 = [0.003, 0.002, 0.0005], [0.07, 1e-4, 0.5], [0.012, 2e-5, 0.05]
    n = len(gd)
    got, want, _, _ = _both(gd, g0, g2, [-0.008] * n, [3e-4] * n,
                            [0.01] * n, [0.1 + 0.02j] * n, sg)
    for i in range(n):
        peak = np.abs(want[i]).max()
        assert np.abs(got[i] - want[i]).max() <= 1e-12 * peak, \
            (i, np.abs(got[i] - want[i]).max() / peak)


def _stores_and_extras():
    """60 synthetic lines (a third with SD_air = 0) for both packages, and
    HT columns for a half of them: Gamma0/n/delta overrides, Gamma2,
    Shift2, nuVC with its exponent, eta, and self-diluent columns."""
    kw = dict(nu_min=995.0, nu_max=1015.0, seed=23, sd_zero_frac=0.3)
    j_store = j_synthetic(60, **kw)
    store = synthetic_lines(60, **kw, **F64)
    rng = np.random.default_rng(4)
    n = len(store)
    on = rng.random(n) < 0.5
    ga = store.host["gamma_air"]
    extras = {
        "gamma_HT_0_air_296": ga * rng.uniform(0.9, 1.1, n) * on,
        "n_HT_air_296": rng.uniform(0.4, 0.8, n) * on,
        "delta_HT_0_air_296": rng.normal(0.0, 0.005, n) * on,
        "deltap_HT_air_296": rng.normal(0.0, 1e-5, n) * on,
        "gamma_HT_2_air_296": ga * rng.uniform(0.05, 0.15, n) * on,
        "delta_HT_2_air_296": rng.normal(0.0, 5e-4, n) * on,
        "nu_HT_air": rng.uniform(0.0, 0.05, n) * on,
        "kappa_HT_air": rng.uniform(0.0, 1.0, n) * on,
        "eta_HT_air": rng.uniform(0.0, 0.3, n) * on,
        "gamma_HT_0_self_296": store.host["gamma_self"] * on,
        "eta_HT_self": rng.uniform(0.0, 0.2, n) * on,
    }
    return j_store, store, extras


@pytest.mark.parametrize("diluent", [{"air": 1.0},
                                     {"air": 0.7, "self": 0.3}])
def test_resolve_ht_columns_matches_jax(diluent):
    """hapi's fallbacks per diluent, column for column, exactly."""
    j_store, store, extras = _stores_and_extras()
    got = ht_driver.resolve_ht_columns(store, extras, diluent)
    want = j_drv.resolve_ht_columns(j_store.host_view(), extras, diluent)
    assert len(got) == len(want) == len(diluent)
    for g, w in zip(got, want):
        assert g[0] == w[0]
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, np.asarray(b))
    # and without extras: every HT column falls back to the Voigt ones
    bare = ht_driver.resolve_ht_columns(store, None, diluent)
    j_bare = j_drv.resolve_ht_columns(j_store.host_view(), None, diluent)
    for g, w in zip(bare, j_bare):
        for a, b in zip(g[1:], w[1:]):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("override", [False, True])
def test_ht_params_matches_jax(iso_tables, override):
    """The (T, p) scaling of the resolved air+self columns at three states,
    with the resolved abundances or the layered OD's per-layer override
    ``[1 - x_self, x_self]``: every parameter, and eta as its real pair,
    within 1e-12 relative."""
    j_store, store, extras = _stores_and_extras()
    dil = {"air": 1.0, "self": 1.0} if override else {"air": 0.8,
                                                      "self": 0.2}
    res = ht_driver.resolve_ht_columns(store, extras, dil)
    j_res = j_drv.resolve_ht_columns(j_store.host_view(), extras, dil)
    T = np.array([296.0, 250.0, 215.0])
    p = np.array([1.0, 0.4, 0.05])
    x_self = np.random.default_rng(9).uniform(0.0, 0.05, (3, len(store)))
    abun = ([torch.as_tensor(1.0 - x_self), torch.as_tensor(x_self)]
            if override else None)
    got = ht_driver.ht_params(res, store, IsoTables.load(**F64),
                              torch.as_tensor(T)[:, None],
                              torch.as_tensor(p)[:, None], wing_abs=0.2,
                              abun=abun)
    for i in range(3):
        want = j_drv.ht_params(
            j_res, j_store, iso_tables, T[i], p[i], wing_abs=0.2,
            abun=([jnp.asarray(1.0 - x_self[i]), jnp.asarray(x_self[i])]
                  if override else None))
        want = dict(want, eta_r=np.real(want["eta"]),
                    eta_i=np.imag(want["eta"]))
        for key in ("strength", "gamma_d", "gamma0", "shift0", "gamma2",
                    "shift2", "nuvc", "eta_r", "eta_i", "wing"):
            a = got[key][i].numpy()
            b = np.broadcast_to(np.asarray(want[key]), a.shape)
            assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), key
        assert np.abs(want["eta_i"]).max() > 0.0
