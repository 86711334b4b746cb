"""The Hartmann-Tran path of the port (``make_ht_fn``, ``make_od_ht_fn``,
K5's plain version) against radtxfr_tpu's (``make_ht_pallas_fn``,
``make_od_ht_pallas_fn``, ``xsect_ht_pallas``).

The JAX side runs its Pallas kernels in interpret mode with
``fast_rcp=False``; the port runs the plain versions of its CUDA kernels
(CPU tensors, float32). Inputs are drawn with NumPy from fixed seeds and
handed to both. Every plan either builder makes is recorded in the order
it is made and held integer-exact against the other's.

Bounds. Both packages evaluate pcqsdhc in float32, whose PART4 difference
w(Z1) - w(Z2) and final A / (1 - d0 A + e2 B) amplify rounding: each is
~2.6e-5 of peak from a float64 run of the same plan (measured on the
CPU), and the JAX package's own float32 HT bound is 5e-5 of peak
(``tests/test_htp_real.py:104``). The HT values are held to that bound.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
from radtxfr_tpu.atmos.profile import AtmosphericState as JState
from radtxfr_tpu.kernels import pallas_xsect as px
from radtxfr_tpu.kernels.htp_real import ht_line_constants as j_consts
from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic
from radtxfr_tpu.products import od as j_od
from radtxfr_tpu_torch.atmos.profile import AtmosphericState
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.kernels.fused_ht import xsect_ht_plain
from radtxfr_tpu_torch.kernels.fused_xsect import device_plan
from radtxfr_tpu_torch.kernels.htp_real import HT_CONST_KEYS
from radtxfr_tpu_torch.lines.store import IsoTables
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
from radtxfr_tpu_torch.products import od
from port_fixtures import one_torch_thread  # noqa: F401

F32 = dict(device="cpu", dtype=torch.float32)
F64 = dict(device="cpu", dtype=torch.float64)
HT_BOUND = 5e-5


def _same_plan(a, b):
    assert (a.tile, a.block, a.n_tiles, a.n_blocks, a.max_blocks) == \
        (b.tile, b.block, b.n_tiles, b.n_blocks, b.max_blocks)
    assert (a.grid.x0, a.grid.dx, a.grid.n) == (b.grid.x0, b.grid.dx,
                                                b.grid.n)
    for f in ("starts", "counts", "k_line", "frac0", "gather"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.max_wing == b.max_wing
    if a.wing_line is None or b.wing_line is None:
        assert a.wing_line is None and b.wing_line is None
    else:
        np.testing.assert_array_equal(a.wing_line, b.wing_line)


def _recorder(monkeypatch, module):
    """Record every plan ``module.plan_buckets_packed`` makes."""
    made, orig = [], module.plan_buckets_packed

    def rec(*args, **kw):
        plan = orig(*args, **kw)
        made.append(plan)
        return plan

    monkeypatch.setattr(module, "plan_buckets_packed", rec)
    return made


def _ht_lines(n=60, lo=995.0, hi=1015.0, seed=31, frac=0.4, rng_seed=7):
    """``n`` synthetic lines for both packages (``frac`` with SD_air = 0:
    the Voigt degeneration; the rest SD-Voigt) and HT columns making the
    first third live-HT lines (nuVC, eta, Shift2): all three routes."""
    kw = dict(nu_min=lo, nu_max=hi, seed=seed, sd_zero_frac=frac)
    rng = np.random.default_rng(rng_seed)
    third = n // 3
    on = np.arange(n) < third
    extras = {"nu_HT_air": rng.uniform(0.01, 0.05, n) * on,
              "kappa_HT_air": rng.uniform(0.0, 1.0, n) * on,
              "eta_HT_air": rng.uniform(0.1, 0.3, n) * on,
              "delta_HT_2_air_296": rng.normal(0.0, 5e-4, n) * on}
    return j_synthetic(n, **kw), synthetic_lines(n, **kw, **F32), extras


def _states(n_lay=5, **kw):
    """Five layers of the standard atmosphere (1013 .. 1 hPa), for both
    (the port's as ``kw`` says, float32 by default; the plans read it)."""
    j_atm = j_std_atmosphere()
    idx = np.linspace(0, 60, n_lay).astype(int)
    cols = {f: np.asarray(getattr(j_atm, f))[idx]
            for f in ("z0", "z1", "pl", "p", "T", "vmr")}
    return (JState(**{f: jnp.asarray(v) for f, v in cols.items()}),
            AtmosphericState.from_numpy(**cols, **(kw or F32)))


def _modes(fn):
    """The port's passes in the order of the JAX builders' work report:
    the classic passes, then the coarse and the correction passes."""
    return [c[2] for c in (*fn.calls, *fn.coarse_calls, *fn.corr_calls)]


LATTICE = dict(axis=(1001.0, 1009.0, 0.01), T=[260.0, 296.0, 320.0],
               p=[0.8, 1.0, 0.9])
COARSE = dict(axis=(560.0, 640.0, 0.01), T=[260.0, 296.0], p=[0.8, 1.0])


@pytest.mark.parametrize("far_method", ["classic", "coarse"])
def test_ht_lattice_plans_match_jax(monkeypatch, iso_tables, far_method):
    """make_ht_fn against make_ht_pallas_fn: the same passes in the same
    order and every plan integer-exact, mixed routing (K5, K1 sdvoigt and
    full), and on the coarse-far route (30 cm^-1 absolute wings, R = 16)
    the coarse, correction and core plans."""
    coarse = far_method == "coarse"
    case = COARSE if coarse else LATTICE
    j_store, store, extras = (_ht_lines(90, 520.0, 680.0) if coarse
                              else _ht_lines())
    axis = arange_drift_free(*case["axis"])
    kw = dict(extras=extras, far_method=far_method, coarse_r=16,
              wing_abs=30.0 if coarse else 0.0)
    j_made = _recorder(monkeypatch, px)
    j_fn = j_od.make_ht_pallas_fn(j_store, iso_tables, axis, case["T"],
                                  case["p"], **kw)
    made = _recorder(monkeypatch, od)
    # float64 isotopologue tables, as the JAX fixture's: the planning's
    # Doppler widths read their molar masses
    fn = od.make_ht_fn(store, IsoTables.load(**F64), axis, case["T"],
                       case["p"], **kw)
    assert _modes(fn) == [r["mode"] for r in j_fn.work_report]
    want_modes = ({"ht", "sdvoigt_core", "core", "sdvoigt_asym", "asym",
                   "corr:16:sdvoigt", "corr:16:voigt"} if coarse
                  else {"ht", "sdvoigt", "full"})
    assert set(_modes(fn)) == want_modes
    assert len(made) == len(j_made) > 0
    for a, b in zip(made, j_made):
        _same_plan(a, b)


@pytest.mark.parametrize("differentiable", [False, True])
def test_od_ht_plans_match_jax(monkeypatch, iso_tables, differentiable):
    """make_od_ht_fn against make_od_ht_pallas_fn on five layers, plain and
    differentiable (whose tangent-kernel block caps shape the plans): the
    same passes and layer groups, every plan integer-exact."""
    j_store, store, extras = _ht_lines(120, 795.0, 835.0, seed=41, frac=0.3)
    j_atm, atm = _states(**F64)
    axis = arange_drift_free(800.0, 830.0, 0.005)
    j_made = _recorder(monkeypatch, px)
    j_fn = j_od.make_od_ht_pallas_fn(j_store, iso_tables, axis, j_atm,
                                     extras=extras, tile=128,
                                     differentiable=differentiable)
    made = _recorder(monkeypatch, od)
    fn = od.make_od_ht_fn(store, IsoTables.load(**F64), axis, atm,
                          extras=extras, tile=128,
                          differentiable=differentiable)
    assert _modes(fn) == [r["mode"] for r in j_fn.work_report]
    assert {"ht", "sdvoigt", "full"} <= set(_modes(fn))
    assert len(made) == len(j_made) > 0
    for a, b in zip(made, j_made):
        _same_plan(a, b)


def test_ht_plain_matches_pallas():
    """K5's plain version against xsect_ht_pallas (interpret) on one packed
    plan (30 lines, 3 layers, tile 128) with random HT constants, a third
    of the lines in PART1 (Gamma2 = Shift2 = 0), the rest with complex
    eta: within the HT bound of peak (measured 6.7e-6)."""
    rng = np.random.default_rng(0)
    g = px.UniformGrid(x0=1000.0, dx=0.01, n=1024)
    n_lines, n_lay = 30, 3
    nu0 = np.sort(rng.uniform(1000.5, 1009.5, n_lines))
    plan = px.plan_buckets_packed(nu0, g, 3.0, tile=128, block="auto")
    mk = lambda lo, hi: rng.uniform(lo, hi, (n_lay, n_lines)).astype(  # noqa
        np.float32)
    gd, g0 = mk(0.01, 0.05), mk(0.01, 0.1)
    g2 = g0 * mk(0.05, 0.15) * (rng.random((1, n_lines)) < 0.7)
    live = g2 > 0
    s0, s2 = mk(-0.01, 0.01), mk(-5e-4, 5e-4) * live
    nuvc, er, ei = mk(0, 0.05) * live, mk(0, 0.3) * live, \
        mk(-0.05, 0.05) * live
    strength = mk(0.5, 2.0)
    wing = np.full((n_lay, n_lines), 3.0, np.float32)
    k = j_consts(*(jnp.asarray(a) for a in (gd, g0, g2, s0, s2, nuvc, er,
                                            ei)))
    k = {key: np.asarray(v, dtype=np.float32) for key, v in k.items()}
    want = np.asarray(px.xsect_ht_pallas(plan, strength, wing, k,
                                         n_weideman=16, interpret=True))
    dp = device_plan(plan, np.arange(n_lines), nu0, device="cpu")
    got = xsect_ht_plain(dp, torch.arange(n_lay, dtype=torch.int32),
                         torch.as_tensor(strength), torch.as_tensor(wing),
                         [torch.tensor(k[key]) for key in HT_CONST_KEYS],
                         16).numpy()
    assert got.shape == want.shape == (n_lay, g.n)
    peak = np.abs(want).max()
    assert peak > 0.0
    assert np.abs(got - want).max() <= HT_BOUND * peak, \
        np.abs(got - want).max() / peak


@pytest.mark.parametrize("far_method", ["classic", "coarse"])
def test_make_ht_fn_matches_jax(iso_tables, far_method):
    """The lattice through both builders, mixed routing, one layer group per
    route (the plans' grouping is held above); on the coarse-far route
    (R = 16) the SD-Voigt and Voigt subsets take the coarse far field:
    within the HT bound of peak."""
    coarse = far_method == "coarse"
    case = COARSE if coarse else LATTICE
    j_store, store, extras = (_ht_lines(90, 520.0, 680.0) if coarse
                              else _ht_lines())
    axis = arange_drift_free(*case["axis"])
    kw = dict(extras=extras, far_method=far_method, coarse_r=16,
              wing_abs=30.0 if coarse else 0.0, max_groups=1)
    T = np.asarray(case["T"])
    p = np.asarray(case["p"])
    j_fn = j_od.make_ht_pallas_fn(j_store, iso_tables, axis, T, p,
                                  fast_rcp=False, **kw)
    want = np.asarray(j_fn(jnp.asarray(T, jnp.float32),
                           jnp.asarray(p, jnp.float32)))
    fn = od.make_ht_fn(store, IsoTables.load(**F32), axis, T, p, **kw)
    got = fn(torch.as_tensor(T, dtype=torch.float32),
             torch.as_tensor(p, dtype=torch.float32)).numpy()
    assert bool(fn.coarse_calls) == coarse
    assert got.shape == want.shape == (T.size, axis.size)
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= HT_BOUND * peak, \
        np.abs(got - want).max() / peak


def test_make_od_ht_fn_matches_jax(iso_tables):
    """The layered HT OD through both builders on five standard-atmosphere
    layers (the air/self mix per layer, column-density strengths, mixed
    routing) with the mt_ckd continuum: within the HT bound of peak."""
    j_store, store, extras = _ht_lines(120, 795.0, 835.0, seed=41, frac=0.3)
    j_atm, atm = _states()
    axis = arange_drift_free(805.0, 815.0, 0.01)
    # one layer group per route (the plans' grouping is held above): the
    # JAX side compiles one interpret-mode kernel per pass
    kw = dict(extras=extras, continuum="mt_ckd", max_groups=1)
    j_fn = j_od.make_od_ht_pallas_fn(j_store, iso_tables, axis, j_atm,
                                     fast_rcp=False, **kw)
    want = np.asarray(j_fn(*(jnp.asarray(getattr(j_atm, f), jnp.float32)
                             for f in ("T", "p", "pl", "vmr"))))
    fn = od.make_od_ht_fn(store, IsoTables.load(**F32), axis, atm, **kw)
    got = fn(atm.T, atm.p, atm.pl, atm.vmr).numpy()
    assert got.shape == want.shape == (5, axis.size)
    peak = np.abs(want).max()
    assert np.abs(got - want).max() <= HT_BOUND * peak, \
        np.abs(got - want).max() / peak


def test_ht_builders_refuse_what_they_cannot_plan():
    """far_method='coarse' without a statically exact wide wing, or with an
    R the correction kernel cannot take, raises while the plans are built;
    'auto' then keeps the classic passes."""
    _, store, extras = _ht_lines(90, 520.0, 680.0)
    iso = IsoTables.load(**F32)
    axis = arange_drift_free(500.0, 700.0, 0.01)
    T, p = [296.0], [1.0]
    for kw in (dict(wing_abs=2.0, coarse_r=16), dict(wing_abs=30.0,
                                                     coarse_r=24)):
        with pytest.raises(ValueError, match="far_method='coarse'"):
            od.make_ht_fn(store, iso, axis, T, p, extras=extras,
                          far_method="coarse", **kw)
        fn = od.make_ht_fn(store, iso, axis, T, p, extras=extras, **kw)
        assert not fn.coarse_calls and {c[2] for c in fn.calls} == {
            "ht", "sdvoigt", "full"}


def test_ht_pass_needs_a_packed_device_plan():
    """The HT pass, as xsect_ht_pallas (pallas_xsect.py:1035-1037), runs
    only on a packed plan, here its DevicePlan, with the 11 constants: a
    host BucketPlan or a short constant list raises before any work."""
    from radtxfr_tpu_torch.kernels.fused_ht import xsect_ht, xsect_ht_jvp
    from radtxfr_tpu_torch.kernels.fused_xsect import (UniformGrid,
                                                       plan_buckets_packed)

    nu0 = np.array([1000.2, 1000.6])
    plan = plan_buckets_packed(nu0, UniformGrid(1000.0, 0.01, 128), 0.5,
                               tile=128)
    one = torch.ones((1, 2))
    consts = [one] * len(HT_CONST_KEYS)
    lay = torch.zeros(1, dtype=torch.int32)
    with pytest.raises(ValueError, match="packed plan"):
        xsect_ht(plan, lay, one, one, consts)
    dp = device_plan(plan, np.arange(2), nu0, device="cpu")
    with pytest.raises(ValueError, match="HT constants"):
        xsect_ht(dp, lay, one, one, consts[:3])
    with pytest.raises(ValueError, match="HT constants"):
        xsect_ht_jvp(dp, lay, one, one, consts, one[None], consts[:3])
    assert xsect_ht(dp, lay, one, one, consts).shape == (1, 128)
