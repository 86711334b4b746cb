"""Forward-mode tangents of the port's Hartmann-Tran and SD-Voigt ODs
(K6 and K4 behind ``xsect_ht_diff`` and ``xsect_fused_sdvoigt_diff``)
against radtxfr_tpu's.

The JAX side runs its Pallas kernels (and their custom JVPs) in interpret
mode with ``fast_rcp=False``; the port runs the plain versions (CPU
tensors, float32). Inputs are drawn with NumPy from fixed seeds and handed
to both.

Bounds, of each tangent's peak: the SD-Voigt OD's are the JAX package's
own between its Pallas tangent and the float64 jnp engine
(``tests/test_pallas_xsect.py:461-462``: 2e-5 below layer 55, 2e-4 above,
where narrow Doppler cores meet the CPF3 sub-band); the HT OD's 5e-5, the
JAX package's float32 HT bound (``tests/test_pallas_xsect.py:728``). The
tangent kernels' plain versions against the Pallas tangent calls on the
same inputs: the SD-Voigt bound 1e-5 (K4's formula in float32, measured
2.0e-6) and the HT bound 5e-5 where float32 resolves the HT tangent (see
:func:`test_ht_tangent_plain_matches_pallas`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.kernels import pallas_xsect as px
from radtxfr_tpu.kernels.htp_real import ht_line_constants as j_consts
from radtxfr_tpu.products import od as j_od
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.kernels import fused_ht, fused_xsect
from radtxfr_tpu_torch.kernels.htp_real import HT_CONST_KEYS
from radtxfr_tpu_torch.lines.store import IsoTables
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic
from radtxfr_tpu_torch.products import od
from port_fixtures import one_torch_thread  # noqa: F401
from test_torch_ht import F32, _ht_lines, _states

HT_BOUND = 5e-5
SD_BOUND = 1e-5


def _j_state(j_atm):
    return tuple(jnp.asarray(getattr(j_atm, f), jnp.float32)
                 for f in ("T", "p", "pl", "vmr"))


def _rel_rows(got, want):
    return np.abs(got - want).max(axis=1) / np.abs(want).max()


@pytest.fixture(scope="module")
def ht_od(iso_tables):
    """make_od_ht_fn and make_od_ht_pallas_fn, both differentiable, on five
    layers (60 lines, 40% live HT, one layer group per route: the JAX side
    compiles one interpret-mode tangent kernel per pass, once for both
    tests)."""
    j_store, store, extras = _ht_lines(60, 800.0, 820.0, seed=77, frac=0.4)
    j_atm, atm = _states()
    axis = arange_drift_free(805.0, 815.0, 0.01)
    j_fn = j_od.make_od_ht_pallas_fn(j_store, iso_tables, axis, j_atm,
                                     extras=extras, differentiable=True,
                                     fast_rcp=False, max_groups=1)
    fn = od.make_od_ht_fn(store, IsoTables.load(**F32), axis, atm,
                          extras=extras, differentiable=True, max_groups=1)
    assert {c[2] for c in fn.calls} == {"ht", "sdvoigt", "full"}
    T, p, pl, vmr = _j_state(j_atm)

    def j_jvp(v):
        return jax.jvp(lambda t: j_fn(t, p, pl, vmr), (T,),
                       (jnp.asarray(v),))

    return fn, atm, j_jvp


def test_od_ht_jvp_matches_jax(ht_od):
    """``torch.func.jvp`` of make_od_ht_fn(differentiable=True) against
    ``jax.jvp`` of make_od_ht_pallas_fn(differentiable=True), a T direction
    over five layers: the primal and the tangent within the HT bound (all
    three routes: K6, K4 and K3's plain versions)."""
    fn, atm, j_jvp = ht_od
    v = np.linspace(0.5, 1.5, 5).astype(np.float32)
    want, want_t = (np.asarray(a) for a in j_jvp(v))
    got, got_t = torch.func.jvp(
        lambda t: fn(t, atm.p, atm.pl, atm.vmr), (atm.T,),
        (torch.as_tensor(v),))
    assert _rel_rows(got.numpy(), want).max() <= HT_BOUND
    assert np.abs(want_t).max() > 0.0
    assert _rel_rows(got_t.numpy(), want_t).max() <= HT_BOUND, \
        _rel_rows(got_t.numpy(), want_t)


def test_od_ht_jacfwd_layer3_matches_jax(ht_od):
    """d OD / d T[3] by ``torch.func.jacfwd`` (a ``vmap`` of ``jvp``, the
    tangent kernels' batch rule) against ``jax.jvp`` of the JAX builder in
    the one-hot direction, the bench's ``ht_jacobian_jvp_per_s``: within
    the HT bound of the Jacobian's peak; only layer 3 moves."""
    fn, atm, j_jvp = ht_od
    lay = 3
    e = np.zeros(5, dtype=np.float32)
    e[lay] = 1.0
    want = np.asarray(j_jvp(e)[1])

    def of_t(t):
        return fn(torch.cat([atm.T[:lay], t[None], atm.T[lay + 1:]]),
                  atm.p, atm.pl, atm.vmr)

    got = torch.func.jacfwd(of_t)(atm.T[lay]).numpy()
    assert got.shape == want.shape == (5, 1001)
    assert np.abs(got[np.arange(5) != lay]).max() == 0.0
    peak = np.abs(want).max()
    assert peak > 0.0
    assert np.abs(got - want).max() <= HT_BOUND * peak, \
        np.abs(got - want).max() / peak


def test_od_sdvoigt_jvp_matches_jax(iso_tables):
    """``torch.func.jvp`` of make_od_fn(profile='sdvoigt',
    differentiable=True) (K4 on the sd_air != 0 lines, K3 on the rest)
    against ``jax.jvp`` of make_od_pallas_fn with the same options; the
    primal equals the single-pass non-differentiable build's."""
    kw = dict(nu_min=795.0, nu_max=835.0, seed=53, sd_zero_frac=0.3)
    j_atm, atm = _states()
    axis = arange_drift_free(805.0, 815.0, 0.01)
    j_fn = j_od.make_od_pallas_fn(j_synthetic(120, **kw), iso_tables, axis,
                                  j_atm, profile="sdvoigt",
                                  differentiable=True, fast_rcp=False)
    T, p, pl, vmr = _j_state(j_atm)
    v = np.linspace(0.5, 1.5, 5).astype(np.float32)
    _, want_t = jax.jvp(lambda t: j_fn(t, p, pl, vmr), (T,),
                        (jnp.asarray(v),))
    store = synthetic_lines(120, **kw, **F32)
    iso = IsoTables.load(**F32)
    fn = od.make_od_fn(store, iso, axis, atm, profile="sdvoigt",
                       differentiable=True)
    assert {c[2] for c in fn.calls} == {"sdvoigt", "full"}
    got, got_t = torch.func.jvp(
        lambda t: fn(t, atm.p, atm.pl, atm.vmr), (atm.T,),
        (torch.as_tensor(v),))
    fn0 = od.make_od_fn(store, iso, axis, atm, profile="sdvoigt")
    want0 = fn0(atm.T, atm.p, atm.pl, atm.vmr).numpy()
    assert np.abs(got.numpy() - want0).max() <= SD_BOUND * np.abs(
        want0).max()
    want_t = np.asarray(want_t)
    rel = _rel_rows(got_t.numpy(), want_t)
    layer = np.linspace(0, 60, 5).astype(int)
    assert rel[layer < 55].max() <= 2e-5, rel
    assert rel.max() <= 2e-4, rel


@pytest.fixture(scope="module")
def tangent_case():
    """One packed plan (30 lines, 3 layers, tile 128) with random SD-Voigt
    and HT parameters and two directions of random tangents for each
    tangent kernel."""
    rng = np.random.default_rng(0)
    g = px.UniformGrid(x0=1000.0, dx=0.01, n=1024)
    n_lines, n_lay, nd = 30, 3, 2
    nu0 = np.sort(rng.uniform(1000.5, 1009.5, n_lines))
    plan = px.plan_buckets_packed(nu0, g, 3.0, tile=128, block="auto")
    mk = lambda lo, hi: rng.uniform(lo, hi, (n_lay, n_lines)).astype(  # noqa
        np.float32)
    gd, g0 = mk(0.01, 0.05), mk(0.01, 0.1)
    live = rng.random((1, n_lines)) < 0.7
    g2 = g0 * mk(0.05, 0.15) * live
    s0, s2 = mk(-0.01, 0.01), mk(-5e-4, 5e-4) * live
    ht = (gd, g0, g2, s0, s2, mk(0, 0.05) * live, mk(0, 0.3) * live,
          mk(-0.05, 0.05) * live)
    prm = dict(strength=mk(0.5, 2.0), gd=gd, g0=g0, g2=mk(0.001, 0.01),
               s0=s0, wing=np.full((n_lay, n_lines), 3.0, np.float32))
    tan = lambda scale: (rng.normal(size=(nd, n_lay, n_lines))  # noqa: E731
                         * scale).astype(np.float32)
    # the constants' tangents of directions of the physical parameters (as
    # the OD's are), by jax.jvp of ht_line_constants in float64: independent
    # random tangents of the 11 constants reach float32-ill-conditioned
    # points (1e-3 of peak from float64 in both packages)
    f64 = lambda a: jnp.asarray(a, jnp.float64)  # noqa: E731
    dirs = [tan(np.abs(a).mean()) for a in ht]
    k = j_consts(*map(f64, ht))
    k_t = [jax.jvp(j_consts, tuple(map(f64, ht)),
                   tuple(f64(t[d]) for t in dirs))[1] for d in range(nd)]
    k = {key: np.asarray(k[key], dtype=np.float32) for key in HT_CONST_KEYS}
    k_t = [np.stack([np.asarray(t[key], dtype=np.float32) for t in k_t])
           for key in HT_CONST_KEYS]
    # drawn here, so that each test's inputs do not depend on which tests
    # ran before it in the process
    sd_t = [tan(s) for s in (1.0, 0.01, 0.01, 0.001, 0.001)]
    return dict(plan=plan, nu0=nu0, k=k, k_t=k_t, prm=prm, sd_t=sd_t,
                s_t=tan(1.0), nd=nd, n_lay=n_lay)


def _pallas_args(c, mode):
    plan = c["plan"]
    cfg = (plan.tile, plan.block, plan.n_blocks, plan.n_tiles,
           plan.max_blocks, plan.grid.n, plan.grid.dx, 16, mode, False)
    gth = jnp.asarray(plan.gather)
    pad = lambda a, fill: px._gather_fused(  # noqa: E731
        jnp.atleast_2d(jnp.asarray(a, jnp.float32)), gth, fill)
    wingu = jnp.minimum(jnp.asarray(c["prm"]["wing"]),
                        plan.max_wing) / plan.grid.dx
    tail = (jnp.asarray(plan.starts), jnp.asarray(plan.counts),
            jnp.zeros((plan.n_tiles,), jnp.int32))
    return cfg, pad, pad(wingu, 0.0), tail


def _port_plan(c):
    plan = c["plan"]
    return (fused_xsect.device_plan(plan, np.arange(c["nu0"].size), c["nu0"],
                                    device="cpu"),
            torch.arange(c["n_lay"], dtype=torch.int32))


def test_sdvoigt_tangent_plain_matches_pallas(tangent_case):
    """K4's plain version against _xsect_fused_sdvoigt_jvp_call (interpret)
    on the same plan, parameters and two directions of (strength, gamma_d,
    gamma_0, gamma_2, shift0) tangents: within the SD-Voigt bound."""
    c = tangent_case
    prm = c["prm"]
    cfg, pad, wingu, tail = _pallas_args(c, "sdvoigt")
    tans = c["sd_t"]
    plan = c["plan"]
    want = np.stack([np.asarray(px._xsect_fused_sdvoigt_jvp_call(
        cfg, jnp.asarray(plan.k_line), jnp.asarray(plan.frac0),
        pad(prm["strength"], 0.0), pad(prm["gd"], 1.0), pad(prm["g0"], 1.0),
        pad(prm["g2"], 1.0), pad(prm["s0"], 0.0), wingu,
        *(pad(t[d], 0.0) for t in tans), *tail, interpret=True))
        for d in range(c["nd"])])
    dp, lay = _port_plan(c)
    t = {k: torch.as_tensor(v) for k, v in prm.items()}
    s_t, gd_t, g0_t, g2_t, s0_t = (torch.as_tensor(a) for a in tans)
    got = fused_xsect.xsect_sdvoigt_jvp_plain(
        dp, lay, t["s0"], t["strength"], t["gd"], t["g0"], t["g2"],
        t["wing"], s0_t, s_t, gd_t, g0_t, g2_t).numpy()
    assert got.shape == want.shape == (2, 3, 1024)
    for d in range(c["nd"]):
        peak = np.abs(want[d]).max()
        assert peak > 0.0
        assert np.abs(got[d] - want[d]).max() <= SD_BOUND * peak, \
            np.abs(got[d] - want[d]).max() / peak


def test_ht_tangent_plain_matches_pallas(tangent_case):
    """K6's plain version (torch.func.jvp through pcqsdhc_real, non-finite
    tangents zeroed) against _xsect_fused_ht_jvp_call (jax.jvp inside the
    Pallas kernel, interpret) on the same inputs, two directions of the
    strength and of the 8 physical parameters.

    The real-pair square root's tangent is ill-conditioned where Im(X + Y)
    crosses zero near a grid point (Im sqrt = sqrt((r - a)/2) with r ~ a):
    there both float32 tangents stray from the float64 plain run by up to
    ~6e-3 of peak (measured on the CPU). So: within the HT bound of peak
    wherever JAX's kernel is within it of the float64 run; elsewhere (under
    0.1% of the points) the port no further from the float64 run than twice
    JAX's kernel."""
    c = tangent_case
    k, prm = c["k"], c["prm"]
    cfg, pad, wingu, tail = _pallas_args(c, "ht")
    plan = c["plan"]
    s_t = c["s_t"]
    k_t = c["k_t"]
    consts = tuple(pad(k[key], 1.0 if key == "cte" else 0.0)
                   for key in HT_CONST_KEYS)
    want = np.stack([np.asarray(px._xsect_fused_ht_jvp_call(
        cfg, jnp.asarray(plan.k_line), jnp.asarray(plan.frac0),
        pad(prm["strength"], 0.0), wingu, consts, pad(s_t[d], 0.0),
        tuple(pad(t[d], 0.0) for t in k_t), *tail, interpret=True))
        for d in range(c["nd"])])

    def port(dt):
        dp = fused_xsect.device_plan(plan, np.arange(c["nu0"].size),
                                     c["nu0"], device="cpu", dtype=dt)
        t = lambda a: torch.tensor(a, dtype=dt)  # noqa: E731
        return fused_ht.xsect_ht_jvp_plain(
            dp, torch.arange(c["n_lay"], dtype=torch.int32),
            t(prm["strength"]), t(prm["wing"]),
            [t(k[key]) for key in HT_CONST_KEYS], t(s_t),
            [t(a) for a in k_t]).numpy()

    got, ref = port(torch.float32), port(torch.float64)
    assert got.shape == want.shape == (2, 3, 1024)
    for d in range(c["nd"]):
        peak = np.abs(ref[d]).max()
        assert peak > 0.0
        fine = np.abs(want[d] - ref[d]) <= HT_BOUND * peak
        assert fine.mean() > 0.99
        assert np.abs(got[d] - want[d])[fine].max() <= HT_BOUND * peak, \
            np.abs(got[d] - want[d])[fine].max() / peak
        assert (np.abs(got[d] - ref[d])[~fine]
                <= 2.0 * np.abs(want[d] - ref[d])[~fine]).all()
