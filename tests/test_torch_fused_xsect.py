"""K1 host planning and plain version against radtxfr_tpu's Pallas kernel.

The JAX side runs the Pallas kernel in interpret mode (as the JAX package's
own tests run it on the CPU), with ``fast_rcp=False``; the port side runs
``xsect_fused_plain``, the plain PyTorch version of the CUDA kernel (which
has no CPU mode: its comparison with the plain version is ``chip_smoke.py``
on the card). Sizes follow ``tests/test_pallas_xsect.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
from radtxfr_tpu.kernels.linemixing import xsect_voigt_mixing as j_mixing
from radtxfr_tpu.kernels.linemixing_data import y_air_for_store as j_y_air
from radtxfr_tpu.kernels.lineparams import compute_line_params as j_params
from radtxfr_tpu.kernels.pallas_xsect import (UniformGrid as JGrid,
                                              plan_buckets_packed as j_packed,
                                              xsect_pallas)
from radtxfr_tpu.kernels.xsect import xsect_from_params as j_xsect
from radtxfr_tpu.lines.derived import derived_lwir_linelist as j_derived
from radtxfr_tpu.lines.store import IsoTables as JIso
from radtxfr_tpu.lines.synthetic import synthetic_lines
from radtxfr_tpu.products.od import _build_od_calls as j_build_od_calls
from radtxfr_tpu.products.od import _host_planning_views as j_host_views
from radtxfr_tpu_torch.atmos.profile import std_atmosphere
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.kernels.fused_xsect import (DevicePlan, UniformGrid,
                                                   device_plan,
                                                   plan_buckets_packed,
                                                   xsect_fused,
                                                   xsect_fused_plain)
from radtxfr_tpu_torch.kernels.lineparams import LineParams
from radtxfr_tpu_torch.kernels.linemixing import xsect_voigt_mixing
from radtxfr_tpu_torch.kernels.linemixing_data import y_air_for_store
from radtxfr_tpu_torch.kernels.xsect import xsect_from_params
from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist
from radtxfr_tpu_torch.lines.store import IsoTables
from radtxfr_tpu_torch.products.od import _build_od_calls, _host_planning_views
from port_fixtures import one_torch_thread  # noqa: F401

AXIS = arange_drift_free(550.0, 575.0, 0.0025)       # 10001 points
PLAN_FIELDS = ("starts", "counts", "k_line", "frac0", "gather")
MODE_PLANS = {"asym": (1024, 32), "core": (256, 16), "mix": (512, 24),
              "full": (512, 16)}
PARAMS = ("shift0", "strength", "gamma_d", "gamma_0", "wing")


def _same_plan(a, b):
    assert (a.tile, a.block, a.n_tiles, a.n_blocks, a.max_blocks) == \
        (b.tile, b.block, b.n_tiles, b.n_blocks, b.max_blocks)
    for f in PLAN_FIELDS:
        # integer-exact, and frac0 bit-exact
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.max_wing == b.max_wing
    np.testing.assert_array_equal(a.wing_line, b.wing_line)


@pytest.mark.parametrize("tile,block,side", [(512, "auto", 0.0),
                                             (1024, 32, 0.0), (256, 16, 0.0),
                                             (2048, "auto", -12.0),
                                             (2048, "auto", 12.0)])
def test_packed_plans_match(tile, block, side):
    """Per-line and scalar wing bounds; ``side`` != 0 places each line's
    interval at nu0 + side (``place_center``, the coarse-far edge bands)."""
    rng = np.random.default_rng(5)
    nu0 = np.sort(rng.uniform(545.0, 580.0, 400))
    wings = rng.uniform(0.01, 3.0, nu0.size)
    pc = None if side == 0.0 else nu0 + side
    for w in (wings, 2.5):        # per-line and scalar wing bounds
        got = plan_buckets_packed(nu0, UniformGrid.from_axis(AXIS), w,
                                  tile=tile, block=block, place_center=pc)
        want = j_packed(nu0, JGrid.from_axis(AXIS), w, tile=tile,
                        block=block, place_center=pc)
        if np.ndim(w) == 0:
            assert got.wing_line is None and want.wing_line is None
            got = dataclasses.replace(got, wing_line=np.zeros(1))
            want = dataclasses.replace(want, wing_line=np.zeros(1))
        _same_plan(got, want)


def test_od_calls_match(iso_tables):
    """The production call decomposition (layer groups x asym/core/mix) on
    the derived list around the 720.8 cm^-1 CO2 Q branch."""
    axis = arange_drift_free(716.0, 726.0, 0.005)
    j_store = j_derived(691.0, 751.0)
    store = derived_lwir_linelist(691.0, 751.0, device="cpu",
                                  dtype=torch.float64)
    mix = np.nonzero(y_air_for_store(store.host_view()))[0]
    np.testing.assert_array_equal(mix, np.nonzero(j_y_air(j_store))[0])
    want = j_build_od_calls(*j_host_views(j_store, iso_tables,
                                          j_std_atmosphere()),
                            JGrid.from_axis(axis), 0.0, 50.0, 8, 512, True,
                            None, None, 4.0, None, 16, "voigt", mix)
    f64 = dict(device="cpu", dtype=torch.float64)
    got = _build_od_calls(*_host_planning_views(store, IsoTables.load(**f64),
                                                std_atmosphere(**f64)),
                          UniformGrid.from_axis(axis), 0.0, 50.0, 8, 512,
                          4.0, core_block=16, mix_idx=mix)
    assert [c[3] for c in got] == [c[3] for c in want]
    assert {c[3] for c in got} == {"asym", "core", "mix"}
    for (lay, lines, plan, _), (j_lay, j_lines, j_plan, _) in zip(got, want):
        np.testing.assert_array_equal(lay, np.asarray(j_lay))
        np.testing.assert_array_equal(lines, np.asarray(j_lines))
        _same_plan(plan, j_plan)


@pytest.fixture(scope="module")
def synthetic_case():
    """300 synthetic lines, 3 layers (1 atm .. 0.05 atm), the JAX float64
    parameters, per-line wing bounds, and mixing coefficients."""
    store = synthetic_lines(300, nu_min=545.0, nu_max=580.0, seed=21)
    iso = JIso.load()
    temps = jnp.asarray([296.0, 250.0, 220.0])
    pres = jnp.asarray([1.0, 0.5, 0.05])
    params = jax.vmap(lambda T, p: j_params(store, iso, T, p))(temps, pres)
    y_mix = np.random.default_rng(0).normal(0.0, 0.3, (3, len(store)))
    wings = np.asarray(params.wing).max(axis=0)
    return store, params, y_mix, wings


def _pallas_plan(case, tile, block):
    store, _, _, wings = case
    return j_packed(np.asarray(store.nu0), JGrid.from_axis(AXIS), wings,
                    tile=tile, block=block)


def _pallas(case, mode, tile, block):
    _, params, y_mix, _ = case
    plan = _pallas_plan(case, tile, block)
    if mode == "mix":
        params = dataclasses.replace(params, gamma_2=jnp.asarray(y_mix))
    out = xsect_pallas(plan, params, interpret=True, n_weideman=16,
                       mode=mode, fused_layers=True, fast_rcp=False)
    return plan, np.asarray(out)


def _plain(case, plan, mode, dtype):
    store, params, y_mix, _ = case
    t = lambda a: torch.tensor(np.asarray(a), dtype=dtype)
    dp = device_plan(plan, np.arange(len(store)), np.asarray(store.nu0),
                     device="cpu", dtype=dtype)
    return xsect_fused_plain(
        dp, torch.arange(3, dtype=torch.int32),
        *(t(getattr(params, f)) for f in PARAMS),
        t(y_mix) if mode == "mix" else None, mode, 16).numpy()


@pytest.fixture(scope="module")
def single_pass(synthetic_case):
    """The Pallas single-pass hum1_wei blend ('full' mode)."""
    return _pallas(synthetic_case, "full", 1024, 32)[1]


@pytest.mark.parametrize("mode", ["asym", "core", "mix", "full"])
def test_plain_matches_pallas(synthetic_case, single_pass, mode):
    plan, want = _pallas(synthetic_case, mode, *MODE_PLANS[mode])
    got = _plain(synthetic_case, plan, mode, torch.float32)
    assert got.shape == want.shape == (3, AXIS.size)
    # Peak: the OD the pass contributes to. The core pass is a difference
    # (Weideman - asymptotic) of two nearly equal values, ~300x smaller
    # than either at |x| + y ~ 5, so float32 rounding differences between
    # two implementations reach ~3e-5 of the core pass's own peak (the
    # Pallas kernel itself is 2e-5 from float64 there); relative to the
    # line OD it corrects (the single-pass blend) they are ~1e-7.
    peak = np.abs(single_pass if mode == "core" else want).max()
    assert np.abs(got - want).max() <= 3e-6 * peak      # test_pallas_xsect:45


def test_two_pass_equals_single_pass(synthetic_case, single_pass):
    """asym + core equals the single-pass blend: against the Pallas 'full'
    mode in float32 (<= 2e-6 of peak, test_pallas_xsect.py:132), and in
    float64 against the port's reference engine pointwise."""
    plans = {m: _pallas_plan(synthetic_case, *MODE_PLANS[m])
             for m in ("asym", "core")}
    two = sum(_plain(synthetic_case, plans[m], m, torch.float32)
              for m in plans)
    peak = np.abs(single_pass).max()
    assert np.abs(two - single_pass).max() <= 2e-6 * peak

    two64 = sum(_plain(synthetic_case, plans[m], m, torch.float64)
                for m in plans)
    store, params, _, _ = synthetic_case
    grid = torch.as_tensor(AXIS)
    for i in range(3):
        ref = xsect_from_params(grid, _layer_params(params, i),
                                n_weideman=16).numpy()
        # float64: the guard is inactive outside the core region and the
        # core pass subtracts the same guarded value it adds back
        assert np.abs(two64[i] - ref).max() <= 1e-10 * np.abs(ref).max()


def _layer_params(params, i):
    return LineParams(**{f: torch.tensor(np.asarray(getattr(params, f))[i])
                         for f in ("nu0", "nu0_shifted", "strength",
                                   "gamma_d", "gamma_0", "wing", "shift0",
                                   "gamma_2")})


def test_reference_engines_match_jax(synthetic_case):
    """The port's line-by-line reference engines (xsect_from_params and
    xsect_voigt_mixing, the contracts K1 is held to) against the JAX jnp
    engines, float64: <= 1e-12 of peak."""
    store, params, y_mix, _ = synthetic_case
    grid = torch.as_tensor(AXIS)
    for i in (0, 2):                       # 1 atm and 0.05 atm
        jp = jax.tree.map(lambda a: a[i], params)
        p = _layer_params(params, i)
        pairs = [(xsect_from_params(grid, p),
                  j_xsect(jnp.asarray(AXIS), jp)),
                 (xsect_voigt_mixing(grid, p, torch.as_tensor(y_mix[i])),
                  j_mixing(jnp.asarray(AXIS), jp, jnp.asarray(y_mix[i])))]
        for got, want in pairs:
            want = np.asarray(want)
            assert np.abs(got.numpy() - want).max() <= \
                1e-12 * np.abs(want).max()


def test_mix_pass_matches_reference_engine(synthetic_case):
    """The mix pass, float64, against the port's mixing engine with the
    same 16 Weideman terms: the same unguarded blend, pointwise."""
    plan = _pallas_plan(synthetic_case, *MODE_PLANS["mix"])
    got = _plain(synthetic_case, plan, "mix", torch.float64)
    _, params, y_mix, _ = synthetic_case
    for i in range(3):
        ref = xsect_voigt_mixing(torch.as_tensor(AXIS), _layer_params(
            params, i), torch.as_tensor(y_mix[i]), n_weideman=16).numpy()
        assert np.abs(got[i] - ref).max() <= 1e-10 * np.abs(ref).max()


def test_padding_sentinel_never_passes_the_mask(synthetic_case):
    """Padding slots (line -1, k_line parked at -2**30) contribute nothing:
    a plan packed in blocks of 8 (with padding) gives the output of the
    same lines packed one per block (no padding at all), and a plan of
    padding slots only is zero even with an unbounded wing cap."""
    store, params, y_mix, wings = synthetic_case
    outs = []
    for block in (8, 1):
        plan = _pallas_plan(synthetic_case, 512, block)
        assert (plan.gather < 0).any() == (block == 8)
        outs.append(_plain(synthetic_case, plan, "mix", torch.float64))
    assert np.abs(outs[0] - outs[1]).max() <= 1e-13 * np.abs(outs[1]).max()

    n_pts, tile, block = 4096, 1024, 8
    n_tiles = n_pts // tile
    n_slots = n_tiles * block
    dp = DevicePlan(
        tile=tile, block=block, n_tiles=n_tiles, max_blocks=1, dx=0.0005,
        n_out=n_pts,
        starts=torch.arange(n_tiles, dtype=torch.int32),
        counts=torch.ones(n_tiles, dtype=torch.int32),
        k_line=torch.full((n_slots,), -(2 ** 30), dtype=torch.int32),
        frac0=torch.zeros(n_slots),
        line=torch.full((n_slots,), -1, dtype=torch.int32),
        wcap=torch.full((n_slots,), 1e30))
    one = lambda v: torch.full((1, 1), v)
    for mode in ("asym", "core", "mix", "full"):
        out = xsect_fused(dp, torch.zeros(1, dtype=torch.int32), one(0.0),
                          one(1e3), one(1e-3), one(1e-2), one(1e30),
                          one(0.5), mode)
        assert out.shape == (1, n_pts)
        assert torch.count_nonzero(out) == 0
