"""The cross-section lattice path of the port (``make_xsect_fn``, the
SD-Voigt, Lorentz, Doppler and coarse-far modes of K1, ``make_od_fn`` with
those profiles) against radtxfr_tpu.

The JAX side runs its Pallas kernels in interpret mode with
``fast_rcp=False`` (as the JAX package's own tests run them on the CPU);
the port runs the plain versions of its CUDA kernels (CPU tensors). Inputs
are drawn with NumPy from fixed seeds and handed to both. Plans are held
integer-exact; values within the bound each test states.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
from radtxfr_tpu.atmos.profile import AtmosphericState as JState
from radtxfr_tpu.kernels.lineparams import LineParams as JLineParams
from radtxfr_tpu.kernels.lineparams import compute_line_params as j_params
from radtxfr_tpu.kernels.pallas_xsect import UniformGrid as JGrid
from radtxfr_tpu.kernels.pallas_xsect import plan_buckets_packed as j_packed
from radtxfr_tpu.kernels.pallas_xsect import xsect_pallas
from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic
from radtxfr_tpu.products import od as j_od
from radtxfr_tpu_torch.atmos.profile import AtmosphericState, std_atmosphere
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.kernels.fused_xsect import (UniformGrid, device_plan,
                                                   xsect_fused_plain)
from radtxfr_tpu_torch.kernels.lineparams import compute_line_params
from radtxfr_tpu_torch.lines.store import IsoTables
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
from radtxfr_tpu_torch.products import od
from port_fixtures import one_torch_thread  # noqa: F401

F64 = dict(device="cpu", dtype=torch.float64)
F32 = dict(device="cpu", dtype=torch.float32)
COLUMNS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
           "delta_air", "sd_air", "iso_row", "mol_id")
PARAM_FIELDS = ("nu0_shifted", "strength", "gamma_d", "gamma_0", "wing",
                "shift0", "gamma_2")
#: the bound of each mode's plain version against the Pallas kernel, of the
#: pass's own peak: float32 rounding for the Voigt forms; the SD-Voigt
#: block's w(Z1) - w(Z2) difference amplifies it (measured <= 7.6e-6; the
#: Pallas kernel and the plain version are each ~4e-6 from a float64 run of
#: the same plan, and the JAX package's own float32 bound is 2e-5,
#: test_pallas_xsect.py:151)
MODE_BOUND = {"lorentz": 2e-6, "doppler": 2e-6, "sdvoigt": 1e-5,
              "sdvoigt_asym": 1e-5, "sdvoigt_core": 1e-5,
              "corr:64:voigt": 2e-6, "corr:64:voigtfull": 2e-6,
              "corr:64:sdvoigt": 1e-5, "corr:64:sdvoigtfull": 1e-5}
SD_BOUND = 1e-5


@pytest.fixture(scope="module")
def iso64():
    return IsoTables.load(**F64)


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


@pytest.mark.parametrize("sd_zero_frac", [0.0, 0.25])
def test_synthetic_lines_match_jax(sd_zero_frac):
    """The same seed draws the same list, column for column."""
    want = j_synthetic(500, nu_min=300.0, nu_max=900.0, seed=4,
                       sd_zero_frac=sd_zero_frac).host_view()
    got = synthetic_lines(500, nu_min=300.0, nu_max=900.0, seed=4,
                          sd_zero_frac=sd_zero_frac, **F32)
    for f in COLUMNS:
        np.testing.assert_array_equal(got.host[f],
                                      np.asarray(getattr(want, f)), err_msg=f)
    assert (got.host["sd_air"] == 0.0).any() == (sd_zero_frac > 0.0)


@pytest.mark.parametrize("profile", ["voigt", "sdvoigt", "lorentz", "doppler"])
def test_compute_line_params_profiles_match(iso_tables, iso64, profile):
    """Each driver's rules against JAX, float64, <= 1e-12 relative."""
    j_store = j_synthetic(300, nu_min=600.0, nu_max=700.0, seed=2,
                          sd_zero_frac=0.3)
    store = synthetic_lines(300, nu_min=600.0, nu_max=700.0, seed=2,
                            sd_zero_frac=0.3, **F64)
    T = np.array([296.0, 250.0, 200.0])
    p = np.array([1.0, 0.3, 0.02])
    x_self = np.random.default_rng(3).uniform(0.0, 0.05, (3, len(store)))
    got = compute_line_params(store, iso64, torch.as_tensor(T)[:, None],
                              torch.as_tensor(p)[:, None],
                              vmr_self=torch.as_tensor(x_self), wing_abs=0.5,
                              profile=profile)
    for i in range(3):
        want = j_params(j_store, iso_tables, T[i], p[i],
                        vmr_self=jnp.asarray(x_self[i]), wing_abs=0.5,
                        profile=profile)
        for f in PARAM_FIELDS:
            a = getattr(got, f)[i].numpy()
            b = np.broadcast_to(np.asarray(getattr(want, f)), a.shape)
            assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), f


def _states(n_lay=5):
    """Five layers of the standard atmosphere (1013 .. 1 hPa), for both."""
    j_atm = j_std_atmosphere()
    idx = np.linspace(0, 60, n_lay).astype(int)
    j_sub = JState(**{f: jnp.asarray(np.asarray(getattr(j_atm, f))[idx])
                      for f in ("z0", "z1", "pl", "p", "T", "vmr")})
    sub = AtmosphericState.from_numpy(
        **{f: np.asarray(getattr(j_atm, f))[idx]
           for f in ("z0", "z1", "pl", "p", "T", "vmr")}, **F64)
    return j_sub, sub


@pytest.mark.parametrize("profile,two_pass", [
    ("sdvoigt", True), ("sdvoigt", False), ("lorentz", True),
    ("doppler", True)])
def test_od_calls_profiles_match(iso_tables, iso64, profile, two_pass):
    """``_build_od_calls`` by profile: the same passes, layers, lines and
    plans, integer-exact."""
    j_store = j_synthetic(400, nu_min=790.0, nu_max=860.0, seed=7,
                          sd_zero_frac=0.3)
    store = synthetic_lines(400, nu_min=790.0, nu_max=860.0, seed=7,
                            sd_zero_frac=0.3, **F64)
    j_atm, atm = _states()
    axis = arange_drift_free(800.0, 850.0, 0.005)
    want = j_od._build_od_calls(
        *j_od._host_planning_views(j_store, iso_tables, j_atm),
        JGrid.from_axis(axis), 0.0, 50.0, 8, 512, two_pass, None, None, 4.0,
        None, 16, profile)
    got = od._build_od_calls(*od._host_planning_views(store, iso64, atm),
                             UniformGrid.from_axis(axis), 0.0, 50.0, 8, 512,
                             4.0, core_block=16, two_pass=two_pass,
                             profile=profile)
    assert [c[3] for c in got] == [c[3] for c in want]
    assert len({c[3] for c in got}) >= (3 if two_pass and profile ==
                                        "sdvoigt" else 1)
    # without the wing passes (the coarse-far route): JAX's core passes
    cores = od._build_od_calls(*od._host_planning_views(store, iso64, atm),
                               UniformGrid.from_axis(axis), 0.0, 50.0, 8, 512,
                               4.0, core_block=16, two_pass=two_pass,
                               profile=profile, wing_passes=False)
    j_cores = [c for c in want if c[3] in ("core", "sdvoigt_core")]
    assert [c[3] for c in cores] == [c[3] for c in j_cores]
    for (lay, lines, plan, _), (j_lay, j_lines, j_plan, _) in zip(
            got + cores, want + j_cores):
        np.testing.assert_array_equal(lay, np.asarray(j_lay))
        np.testing.assert_array_equal(lines, np.asarray(j_lines))
        _same_plan(plan, j_plan)


def test_coarse_far_planning_matches(iso_tables):
    """The coarse-far route's sizing and plans: near width, disjointness
    bound, correction tile (350 cm^-1 wings at 0.0025 and the layered
    25 cm^-1 convention at 0.01), and every coarse and correction plan
    (edge bands placed at nu0 +- wing) integer-exact."""
    for x0, dx, R, nw, wing in ((400.0, 0.0025, 64, 4.0, 350.0),
                                (480.0, 0.01, 16, 4.0, 25.0),
                                (480.0, 0.01, 16, 4.0, 5.0)):
        g, jg = UniformGrid(x0, dx, 1000), JGrid(x0, dx, 1000)
        assert od._coarse_near_width(R, dx, nw) == \
            j_od._coarse_near_width(R, dx, nw)
        assert od._coarse_far_min_wing(g, R, nw) == \
            j_od._coarse_far_min_wing(jg, R, nw)
        assert od._coarse_tile_corr(g, R, nw, wing) == \
            j_od._coarse_tile_corr(jg, R, nw, wing)
    j_store = j_synthetic(300, nu_min=520.0, nu_max=680.0, seed=9,
                          sd_zero_frac=0.3)
    store = synthetic_lines(300, nu_min=520.0, nu_max=680.0, seed=9,
                            sd_zero_frac=0.3, **F64)
    axis = arange_drift_free(500.0, 700.0, 0.01)
    g, jg = UniformGrid.from_axis(axis), JGrid.from_axis(axis)
    for profile in ("voigt", "sdvoigt"):
        nw = od._coarse_near_width(16, g.dx, 4.0)
        tc = od._coarse_tile_corr(g, 16, nw, 30.0)
        got = od._build_coarse_far_calls(store.host_view(), g, 30.0, profile,
                                         16, nw, 512, tc)
        want = j_od._build_coarse_far_calls(j_store.host_view(), jg, 30.0,
                                            profile, 16, nw, 512, tc)
        assert (got[0].x0, got[0].dx, got[0].n) == \
            (want[0].x0, want[0].dx, want[0].n)
        for g_calls, j_calls in zip(got[1:], want[1:]):
            assert [c[2] for c in g_calls] == [c[2] for c in j_calls]
            for (idx, plan, _), (j_idx, j_plan, _) in zip(g_calls, j_calls):
                np.testing.assert_array_equal(idx, np.asarray(j_idx))
                _same_plan(plan, j_plan)


def test_coarse_far_guard_and_disjointness(iso_tables, iso64):
    """Where a line's near-zone and window-edge plans could share a
    correction tile (wing 4.5 with R = 64 at 0.0025,
    tests/test_pallas_xsect.py:593-627), or halfwidth wings dominate, both
    builders refuse 'coarse' and 'auto' keeps the classic passes; a wide
    statically exact wing takes the coarse route in both."""
    j_store = j_synthetic(200, nu_min=520.0, nu_max=620.0, seed=9,
                          sd_zero_frac=0.3)
    store = synthetic_lines(200, nu_min=520.0, nu_max=620.0, seed=9,
                            sd_zero_frac=0.3, **F32)
    iso = IsoTables.load(**F32)
    axis = arange_drift_free(500.0, 640.0, 0.0025)
    g = UniformGrid.from_axis(axis)
    assert 16.0 * 64 * g.dx < 4.5 < od._coarse_far_min_wing(g, 64, 4.0)
    T, p = np.array([296.0]), np.array([1.0])
    for wing_abs, wing_hw in ((4.5, 5.0), (5.0, 50.0)):
        kw = dict(profile="voigt", wing_abs=wing_abs, wing_hw=wing_hw,
                  coarse_r=64)
        with pytest.raises(ValueError):
            j_od.make_xsect_pallas_fn(j_store, iso_tables, axis, T, p,
                                      far_method="coarse", **kw)
        with pytest.raises(ValueError, match="far_method='coarse'"):
            od.make_xsect_fn(store, iso, axis, T, p, far_method="coarse",
                             **kw)
        fn = od.make_xsect_fn(store, iso, axis, T, p, far_method="auto", **kw)
        assert not fn.coarse_calls and not fn.corr_calls
        assert {c[2] for c in fn.calls} - {"core"} == {"asym"}
    fn = od.make_xsect_fn(store, iso, axis, T, p, profile="sdvoigt",
                          wing_abs=60.0)
    assert {c[2] for c in fn.coarse_calls} == {"asym", "sdvoigt_asym"}
    assert {c[2] for c in fn.corr_calls} == {"corr:64:voigt",
                                             "corr:64:sdvoigt"}
    assert {c[2] for c in fn.calls} <= {"core", "sdvoigt_core"}


@pytest.fixture(scope="module")
def random_case():
    """The random-parameter template of tests/test_pallas_xsect.py:795-825:
    37 lines, 5 layers, tile 256 (R = 64 divides it)."""
    rng = np.random.default_rng(0)
    g = JGrid(x0=1000.0, dx=0.01, n=2048)
    n_lines, n_lay = 37, 5
    nu0 = np.sort(rng.uniform(1000.5, 1019.5, n_lines))
    plan = j_packed(nu0, g, 3.0, tile=256, block="auto")
    mk = lambda lo, hi: rng.uniform(lo, hi, (n_lay, n_lines)).astype(  # noqa
        np.float32)
    prm = dict(strength=mk(0.5, 2.0), gamma_d=mk(0.01, 0.05),
               gamma_0=mk(0.01, 0.1), gamma_2=mk(0.001, 0.01),
               shift0=mk(-0.01, 0.01),
               wing=np.full((n_lay, n_lines), 3.0, dtype=np.float32))
    return nu0, plan, prm


def _pallas_mode(case, mode):
    nu0, plan, prm = case
    nu = jnp.asarray(np.tile(nu0, (prm["wing"].shape[0], 1)),
                     dtype=jnp.float32)
    params = JLineParams(**{k: jnp.asarray(v) for k, v in prm.items()},
                         nu0=nu, nu0_shifted=nu)
    return np.asarray(xsect_pallas(plan, params, interpret=True,
                                   n_weideman=16, mode=mode,
                                   fused_layers=True, fast_rcp=False))


def _plain_mode(case, mode, dtype=torch.float32):
    nu0, plan, prm = case
    dp = device_plan(plan, np.arange(nu0.size), nu0, device="cpu",
                     dtype=dtype)
    t = {k: torch.as_tensor(v, dtype=dtype) for k, v in prm.items()}
    lay = torch.arange(prm["wing"].shape[0], dtype=torch.int32)
    return xsect_fused_plain(dp, lay, t["shift0"], t["strength"],
                             t["gamma_d"], t["gamma_0"], t["wing"], None,
                             mode, 16, gamma_2=t["gamma_2"]).numpy()


@pytest.mark.parametrize("mode", list(MODE_BOUND))
def test_new_modes_plain_match_pallas(random_case, mode):
    """Each K1 mode of this path: the plain version against the Pallas
    kernel on the same plan and parameters."""
    want = _pallas_mode(random_case, mode)
    got = _plain_mode(random_case, mode)
    assert got.shape == want.shape == (5, 2048)
    peak = np.abs(want).max()
    assert peak > 0.0
    assert np.abs(got - want).max() <= MODE_BOUND[mode] * peak, \
        np.abs(got - want).max() / peak


def test_sdvoigt_asym_plus_core_is_sdvoigt(random_case):
    """sdvoigt_asym + sdvoigt_core equals sdvoigt: pointwise in float64
    (the core subtracts the same guarded form the asym pass adds), and
    within the SD-Voigt float32 bound in float32."""
    for dtype, bound in ((torch.float64, 1e-10), (torch.float32, SD_BOUND)):
        full = _plain_mode(random_case, "sdvoigt", dtype)
        two = (_plain_mode(random_case, "sdvoigt_asym", dtype)
               + _plain_mode(random_case, "sdvoigt_core", dtype))
        assert np.abs(two - full).max() <= bound * np.abs(full).max()


def _xs_pair(iso_tables, profile, far_method, coarse_r=16, wing_abs=40.0):
    """One lattice through both builders: 100 synthetic lines over
    795-825 cm^-1, 800-820 at 0.005, three (T, p) states."""
    kw = dict(nu_min=795.0, nu_max=825.0, seed=9, sd_zero_frac=0.3)
    axis = arange_drift_free(800.0, 820.0, 0.005)
    T, p = np.array([275.0, 296.0, 320.0]), np.array([0.85, 1.0, 1.05])
    args = dict(profile=profile, wing_abs=wing_abs, far_method=far_method,
                coarse_r=coarse_r)
    j_fn = j_od.make_xsect_pallas_fn(j_synthetic(100, **kw), iso_tables,
                                     axis, T, p, fast_rcp=False, **args)
    want = np.asarray(j_fn(jnp.asarray(T, dtype=jnp.float32),
                           jnp.asarray(p, dtype=jnp.float32)))
    fn = od.make_xsect_fn(synthetic_lines(100, **kw, **F32),
                          IsoTables.load(**F32), axis, T, p, **args)
    got = fn(torch.as_tensor(T, dtype=torch.float32),
             torch.as_tensor(p, dtype=torch.float32)).numpy()
    return fn, got, want


@pytest.mark.parametrize("profile,far_method", [
    ("voigt", "classic"), ("sdvoigt", "classic"), ("voigt", "coarse"),
    ("sdvoigt", "coarse")])
def test_make_xsect_fn_matches_jax(iso_tables, profile, far_method):
    """make_xsect_fn against make_xsect_pallas_fn (interpret) on the same
    lattice, classic and coarse (R = 16): within 2e-6 of peak (Voigt) and
    the SD-Voigt bound."""
    fn, got, want = _xs_pair(iso_tables, profile, far_method)
    assert bool(fn.coarse_calls) == (far_method == "coarse")
    assert got.shape == want.shape
    peak = np.abs(want).max()
    bound = 2e-6 if profile == "voigt" else SD_BOUND
    assert np.abs(got - want).max() <= bound * peak, \
        np.abs(got - want).max() / peak


@pytest.mark.parametrize("coarse_r", [4, 24])
def test_coarse_route_needs_a_supported_R(coarse_r):
    """An R the CUDA correction pass cannot take (below 8, or not dividing
    its 256-point slice) is refused while the plans are built, on the CPU
    as on a card: 'coarse' raises, 'auto' keeps the classic passes, where
    R = 16 takes the coarse route on the same lattice."""
    kw = dict(nu_min=795.0, nu_max=825.0, seed=9, sd_zero_frac=0.3)
    store = synthetic_lines(100, **kw, **F32)
    iso = IsoTables.load(**F32)
    axis = arange_drift_free(800.0, 820.0, 0.005)
    T, p = np.array([275.0, 320.0]), np.array([1.0, 1.0])
    build = lambda R, m: od.make_xsect_fn(  # noqa: E731
        store, iso, axis, T, p, profile="sdvoigt", wing_abs=40.0,
        far_method=m, coarse_r=R)
    assert build(16, "auto").coarse_calls
    with pytest.raises(ValueError, match="coarse_r"):
        build(coarse_r, "coarse")
    fn = build(coarse_r, "auto")
    assert not fn.coarse_calls and not fn.corr_calls
    assert {c[2] for c in fn.calls} <= {"asym", "core", "sdvoigt_asym",
                                        "sdvoigt_core"}


@pytest.mark.parametrize("profile,bound", [("voigt", 1e-6),
                                           ("sdvoigt", 1e-5)])
def test_port_coarse_matches_port_classic(profile, bound):
    """The port's coarse-far lattice against its classic one (R = 16;
    the JAX package's bounds, tests/test_pallas_xsect.py:529)."""
    store = synthetic_lines(400, nu_min=500.0, nu_max=700.0, seed=9,
                            sd_zero_frac=0.3, **F32)
    iso = IsoTables.load(**F32)
    axis = arange_drift_free(480.0, 720.0, 0.01)
    T, p = np.array([260.0, 296.0]), np.array([0.7, 1.0])
    Tt, pt = (torch.as_tensor(a, dtype=torch.float32) for a in (T, p))
    a, b = (od.make_xsect_fn(store, iso, axis, T, p, profile=profile,
                             wing_abs=30.0, far_method=m,
                             coarse_r=16)(Tt, pt).numpy()
            for m in ("classic", "coarse"))
    peak = np.abs(a).max()
    assert np.abs(a - b).max() < bound * peak, np.abs(a - b).max() / peak


@pytest.mark.parametrize("profile,wing_abs", [("sdvoigt", 0.0),
                                              ("voigt", 25.0),
                                              ("sdvoigt", 25.0)])
def test_make_od_fn_profiles_match_jax(iso_tables, profile, wing_abs):
    """make_od_fn(profile='sdvoigt') and the layered coarse-far branch
    (absolute 25 cm^-1 wings, R = 16) against make_od_pallas_fn on five
    standard-atmosphere layers: the same passes and plans, the OD within
    2e-6 of peak (Voigt) and the SD-Voigt bound."""
    kw = dict(nu_min=795.0, nu_max=855.0, seed=77, sd_zero_frac=0.4)
    j_atm, atm = _states()
    atm32 = AtmosphericState.from_numpy(
        **{f: getattr(atm, f).numpy() for f in ("z0", "z1", "pl", "p", "T",
                                                 "vmr")}, **F32)
    axis = arange_drift_free(800.0, 850.0, 0.01)
    args = dict(profile=profile, wing_abs=wing_abs, coarse_r=16)
    j_fn = j_od.make_od_pallas_fn(j_synthetic(150, **kw), iso_tables, axis,
                                  j_atm, fast_rcp=False, **args)
    want = np.asarray(j_fn(*(jnp.asarray(getattr(j_atm, f), jnp.float32)
                             for f in ("T", "p", "pl", "vmr"))))
    fn = od.make_od_fn(synthetic_lines(150, **kw, **F32),
                       IsoTables.load(**F32), axis, atm32, **args)
    got = fn(atm32.T, atm32.p, atm32.pl, atm32.vmr).numpy()
    assert bool(fn.coarse_calls) == (wing_abs > 0.0)
    assert got.shape == want.shape
    peak = np.abs(want).max()
    bound = 2e-6 if profile == "voigt" else SD_BOUND
    assert np.abs(got - want).max() <= bound * peak, \
        np.abs(got - want).max() / peak


def test_unported_branches_raise():
    """Hartmann-Tran has builders of its own (make_ht_fn, make_od_ht_fn):
    profile 'ht' in the Voigt-family builders raises NotImplementedError
    naming them; a differentiable OD has no Lorentz or Doppler tangent."""
    store = synthetic_lines(20, nu_min=795.0, nu_max=805.0, seed=1, **F32)
    iso = IsoTables.load(**F32)
    axis = arange_drift_free(798.0, 802.0, 0.01)
    atm = std_atmosphere(**F32)
    with pytest.raises(NotImplementedError, match="make_od_ht_fn"):
        od.make_od_fn(store, iso, axis, atm, profile="ht")
    with pytest.raises(NotImplementedError, match="make_ht_fn"):
        od.make_xsect_fn(store, iso, axis, [296.0], [1.0], profile="ht")
    with pytest.raises(NotImplementedError, match="tangent"):
        od.make_od_fn(store, iso, axis, atm, profile="lorentz",
                      differentiable=True)
