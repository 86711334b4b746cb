"""The port's layered-OD library API against radtxfr_tpu: shared-block plans
(``plan_buckets``, ``make_od_plan``), the unfused kernel K7's plain version
(``xsect_unfused_plain``), ``compute_od_layers`` on each of its routes, the
pointwise continuum models and the reference engine's profiles.

The JAX side runs its Pallas kernels in interpret mode (as the JAX
package's own tests run them on the CPU) or its jnp engine; the port runs
the plain versions of its CUDA kernels (CPU tensors). Inputs are drawn with
NumPy or the JAX package's own generators from fixed seeds and handed to
both. Plans are held integer-exact; values within the bound each test
states.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.atmos import continuum as j_continuum
from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
from radtxfr_tpu.kernels.lineparams import compute_line_params as j_params
from radtxfr_tpu.kernels.linemixing_data import y_air_for_store as j_y_air
from radtxfr_tpu.kernels.pallas_xsect import UniformGrid as JGrid
from radtxfr_tpu.kernels.pallas_xsect import plan_buckets as j_plan_buckets
from radtxfr_tpu.kernels.pallas_xsect import xsect_pallas
from radtxfr_tpu.kernels.xsect import xsect_from_params as j_xsect
from radtxfr_tpu.lines.derived import derived_lwir_linelist as j_derived
from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic
from radtxfr_tpu.products import od as j_od
from radtxfr_tpu_torch.atmos import continuum
from radtxfr_tpu_torch.atmos.profile import AtmosphericState
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.kernels.fused_xsect import (UniformGrid, plan_buckets,
                                                   plan_buckets_packed,
                                                   xsect_unfused,
                                                   xsect_unfused_plain)
from radtxfr_tpu_torch.kernels.lineparams import compute_line_params
from radtxfr_tpu_torch.kernels.xsect import xsect_from_params
from radtxfr_tpu_torch.lines.store import IsoTables, LineStore
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
from radtxfr_tpu_torch.products import od
from port_fixtures import one_torch_thread  # noqa: F401

F64 = dict(device="cpu", dtype=torch.float64)
F32 = dict(device="cpu", dtype=torch.float32)
FIELDS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
          "delta_air", "sd_air", "iso_row", "mol_id")
STATE = ("z0", "z1", "pl", "p", "T", "vmr")

# tests/test_pallas_xsect.py's case: 700 synthetic lines over 540-610
# cm^-1, 550-600 at 0.0025 (20,001 points), three (T, p) layers, a 12 cm^-1
# wing bound
GRID_AXIS = arange_drift_free(550.0, 600.0, 0.0025)
MAX_WING = 12.0
TEMPS = np.array([296.0, 250.0, 220.0])
PRES = np.array([1.0, 0.5, 0.05])
# tests/test_torch_slice.py's band (the 720.8 cm^-1 CO2 Q branch), every
# eighth StdAtmos layer
SLICE_AXIS = arange_drift_free(716.0, 726.0, 0.005)
SLICE_LAYERS = np.arange(0, 66, 8)


@pytest.fixture(scope="module")
def synthetic():
    """The synthetic case for both packages: the JAX store and layered
    parameters, the port's stores (float32, float64)."""
    j_store = j_synthetic(700, nu_min=540.0, nu_max=610.0, seed=21)
    kw = dict(nu_min=540.0, nu_max=610.0, seed=21)
    return j_store, synthetic_lines(700, **kw, **F32), \
        synthetic_lines(700, **kw, **F64)


def _port_params(store, profile="voigt"):
    dt = store.sw.dtype
    iso = IsoTables.load(device="cpu", dtype=dt)
    col = lambda a: torch.tensor(a, dtype=dt)[:, None]  # noqa: E731
    return compute_line_params(store, iso, col(TEMPS), col(PRES),
                               profile=profile)


def _jax_params(j_store, iso_tables, profile="voigt"):
    return jax.vmap(lambda T, p: j_params(j_store, iso_tables, T, p,
                                          profile=profile))(
        jnp.asarray(TEMPS), jnp.asarray(PRES))


def _same_shared_plan(a, b):
    assert (a.tile, a.block, a.n_tiles, a.n_blocks, a.max_blocks) == \
        (b.tile, b.block, b.n_tiles, b.n_blocks, b.max_blocks)
    for f in ("starts", "counts", "k_line", "frac0"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.max_wing == b.max_wing
    assert a.gather is None and b.gather is None


@pytest.mark.parametrize("tile,block", [(512, 128), (512, "auto"),
                                        (1024, 256), (256, 16)])
def test_plan_buckets_matches_jax(synthetic, tile, block):
    """Shared-block plans, integer-exact, fixed and 'auto' blocks."""
    nu0 = np.asarray(synthetic[0].nu0)
    _same_shared_plan(
        plan_buckets(nu0, UniformGrid.from_axis(GRID_AXIS), MAX_WING,
                     tile=tile, block=block),
        j_plan_buckets(nu0, JGrid.from_axis(GRID_AXIS), MAX_WING, tile=tile,
                       block=block))


@pytest.fixture(scope="module")
def slice_case(iso_tables):
    """The slice band through both packages: the JAX derived list,
    partition tables and StdAtmos layers, and the port's (float32,
    float64) counterparts via the from_numpy converters."""
    atm = j_std_atmosphere()
    atm = atm.replace(**{f: getattr(atm, f)[SLICE_LAYERS] for f in STATE})
    store = j_derived(706.0, 736.0)
    hv = store.host_view()
    iso = jax.device_get(iso_tables)
    port = {}
    for dt in (torch.float32, torch.float64):
        port[dt] = (
            LineStore.from_numpy(**{f: getattr(hv, f) for f in FIELDS},
                                 device="cpu", dtype=dt),
            IsoTables.from_numpy(**{f: getattr(iso, f) for f in
                                    ("q", "abundance", "molar_mass", "mol",
                                     "iso")}, device="cpu", dtype=dt),
            AtmosphericState.from_numpy(
                **{f: np.asarray(getattr(atm, f)) for f in STATE},
                mol_ids=atm.mol_ids, device="cpu", dtype=dt))
    return store, atm, port


@pytest.mark.parametrize("wing_abs,tile,block", [(0.0, 1024, 256),
                                                 (2.0, 512, "auto")])
def test_make_od_plan_matches_jax(slice_case, iso_tables, wing_abs, tile,
                                  block):
    """make_od_plan (max_wing_bound over the layers, then plan_buckets),
    integer-exact, at the defaults and with an absolute wing."""
    store, atm, port = slice_case
    lines, iso, state = port[torch.float64]
    got = od.make_od_plan(lines, iso, SLICE_AXIS, state, wing_abs=wing_abs,
                          tile=tile, block=block)
    want = j_od.make_od_plan(store, iso_tables, SLICE_AXIS, atm,
                             wing_abs=wing_abs, tile=tile, block=block)
    _same_shared_plan(got, want)
    np.testing.assert_array_equal(
        od.max_wing_per_layer(lines, iso, state, wing_abs),
        j_od.max_wing_per_layer(store, iso_tables, atm, wing_abs))


@pytest.mark.parametrize("mode", ["full", "asym", "core", "lorentz",
                                  "doppler"])
def test_unfused_plain_matches_pallas(synthetic, iso_tables, mode):
    """The plain K7 against the Pallas unfused kernel (interpret mode),
    float32, on one shared-block plan: within 2e-6 of the peak of the
    spectrum the pass makes up (its own for full, lorentz and doppler; the
    'full' spectrum for the asym and core parts, as chip_smoke.py holds K1's
    passes to the OD they add to)."""
    j_store, store32, _ = synthetic
    profile = mode if mode in ("lorentz", "doppler") else "voigt"
    nu0 = np.asarray(j_store.nu0)
    plan = plan_buckets(nu0, UniformGrid.from_axis(GRID_AXIS), MAX_WING,
                        tile=512, block=128)
    j_plan = j_plan_buckets(nu0, JGrid.from_axis(GRID_AXIS), MAX_WING,
                            tile=512, block=128)
    jp = _jax_params(j_store, iso_tables, profile)
    want = np.asarray(xsect_pallas(j_plan, jp, interpret=True, mode=mode))
    got = xsect_unfused_plain(plan, _port_params(store32, profile),
                              mode).numpy()
    assert got.shape == want.shape == (3, GRID_AXIS.size)
    peak = np.abs(np.asarray(xsect_pallas(j_plan, jp, interpret=True))
                  if mode in ("asym", "core") else want).max()
    assert np.abs(want).max() > 0.0
    assert np.abs(got - want).max() <= 2e-6 * peak, \
        np.abs(got - want).max() / peak


@pytest.mark.parametrize("profile", ["voigt", "lorentz", "doppler"])
def test_unfused_plain_float64_matches_jnp_engine(synthetic, iso_tables,
                                                  profile):
    """The plain K7 in float64 (modes full, lorentz, doppler) against the
    JAX jnp engine with the wing clamped to the plan's bound, layer by
    layer: within 1e-9 of peak (measured ~2e-10, the Doppler form's exp)."""
    j_store, _, store64 = synthetic
    plan = plan_buckets(store64.host_view().nu0,
                        UniformGrid.from_axis(GRID_AXIS), MAX_WING, tile=512,
                        block=128)
    mode = "full" if profile == "voigt" else profile
    got = xsect_unfused_plain(plan, _port_params(store64, profile),
                              mode).numpy()
    for i in range(3):
        p = j_params(j_store, iso_tables, TEMPS[i], PRES[i], profile=profile)
        p = dataclasses.replace(p, wing=jnp.minimum(p.wing, MAX_WING))
        want = np.asarray(j_xsect(jnp.asarray(GRID_AXIS), p,
                                  profile=profile))
        assert np.abs(got[i] - want).max() <= 1e-9 * np.abs(want).max()


def test_unfused_layered_matches_per_layer(synthetic):
    """Layered parameters give each layer's 1-D result bit for bit
    (``test_pallas_layered_matches_per_layer``), and 1-D input squeezes."""
    _, store32, _ = synthetic
    plan = plan_buckets(store32.host_view().nu0,
                        UniformGrid.from_axis(GRID_AXIS), MAX_WING, tile=512,
                        block=128)
    got = xsect_unfused(plan, _port_params(store32))
    iso = IsoTables.load(**F32)
    for i in range(3):
        single = compute_line_params(store32, iso, float(TEMPS[i]),
                                     float(PRES[i]))
        one = xsect_unfused(plan, single)
        assert one.shape == (GRID_AXIS.size,)
        assert torch.equal(got[i], one)


def test_unfused_packed_plan_matches_shared_plan(synthetic):
    """A packed plan (per-tile gather, blocks of 16) gives the shared-block
    plan's spectrum within 5e-7 of peak (tests/test_pallas_xsect.py:397)."""
    _, store32, _ = synthetic
    nu0 = store32.host_view().nu0
    g = UniformGrid.from_axis(GRID_AXIS)
    prm = _port_params(store32)
    want = xsect_unfused(plan_buckets(nu0, g, MAX_WING, tile=512, block=128),
                         prm).numpy()
    got = xsect_unfused(plan_buckets_packed(nu0, g, MAX_WING, tile=512,
                                            block=16), prm).numpy()
    peak = np.abs(want).max()
    assert np.abs(got - want).max() < 5e-7 * peak


def test_unfused_window_edge_rule(iso_tables):
    """A single strong line: every value lies inside hapi's bisect window
    nu0 - wing < g <= nu0 + wing, whose ends the nonzero run reaches within
    a grid step (``test_pallas_wing_mask_semantics``)."""
    j_store = j_synthetic(1, nu_min=574.0, nu_max=575.0, seed=3)
    store = synthetic_lines(1, nu_min=574.0, nu_max=575.0, seed=3, **F32)
    prm = compute_line_params(store, IsoTables.load(**F32), 296.0, 1.0)
    plan = plan_buckets(store.host_view().nu0,
                        UniformGrid.from_axis(GRID_AXIS), MAX_WING, tile=512,
                        block=128)
    got = xsect_unfused(plan, prm).numpy()
    nu0 = float(np.asarray(j_store.nu0)[0])
    wing = float(torch.clamp(prm.wing, max=MAX_WING)[0])
    g = UniformGrid.from_axis(GRID_AXIS).values()
    inside = (g > nu0 - wing) & (g <= nu0 + wing)
    nz = np.nonzero(got)[0]
    assert got[~inside].max(initial=0.0) == 0.0
    assert abs(nz.min() - np.nonzero(inside)[0].min()) <= 1
    assert abs(nz.max() - np.nonzero(inside)[0].max()) <= 1


def test_unfused_refuses_other_modes(synthetic):
    """The SD-Voigt, mixing and correction modes are the fused kernel's."""
    _, store32, _ = synthetic
    plan = plan_buckets(store32.host_view().nu0,
                        UniformGrid.from_axis(GRID_AXIS), MAX_WING)
    for mode in ("sdvoigt", "mix", "corr:64:voigt"):
        with pytest.raises(ValueError, match="fused kernel"):
            xsect_unfused(plan, _port_params(store32), mode)


@pytest.fixture(scope="module")
def slice_reference(slice_case, iso_tables):
    """JAX's float64 jnp-engine ODs of the slice band, by case."""
    store, atm, _ = slice_case
    lm = {"y_air": j_y_air(store)}
    axis = jnp.asarray(SLICE_AXIS)
    return {
        "voigt": np.asarray(j_od.compute_od_layers(
            store, iso_tables, axis, atm, continuum="mt_ckd")),
        "lorentz": np.asarray(j_od.compute_od_layers(
            store, iso_tables, axis, atm, profile="lorentz")),
        "doppler": np.asarray(j_od.compute_od_layers(
            store, iso_tables, axis, atm, profile="doppler",
            continuum="h2o_empirical")),
        "mixing": np.asarray(j_od.compute_od_layers(
            store, iso_tables, axis, atm, line_mixing=lm,
            continuum="mt_ckd")),
    }, lm


# (route, dtype, case, bound): float64 holds each route to the JAX jnp
# engine at 1e-9 of peak (measured ~1e-15 on the jnp routes); float32 the
# Pallas routes at the JAX package's own bounds for them: the unfused kernel
# 3e-6 (test_pallas_xsect.py:45), the grouped builders 5e-6
# (test_pallas_xsect.py:113)
ROUTES = [
    ("pallas_plan", torch.float64, "voigt", 1e-9),
    ("pallas_plan", torch.float32, "voigt", 3e-6),
    ("pallas", torch.float64, "voigt", 1e-9),
    ("pallas", torch.float32, "voigt", 5e-6),
    ("jnp", torch.float64, "voigt", 1e-9),
    ("jnp", torch.float64, "lorentz", 1e-9),
    ("jnp", torch.float64, "doppler", 1e-9),
    ("jnp", torch.float64, "mixing", 1e-9),
]


@pytest.mark.parametrize("route,dtype,case,bound", ROUTES)
def test_compute_od_layers_matches_jax(slice_case, slice_reference, route,
                                       dtype, case, bound):
    """compute_od_layers on each route against JAX's jnp engine on the
    slice band (continua as the reference case names them): the prebuilt
    make_od_plan route (K7), the builders without a plan (float64 with the
    jnp engine's 24 Weideman terms) and the reference engine."""
    lines, iso, state = slice_case[2][dtype]
    refs, lm = slice_reference
    want = refs[case]
    kw = dict(profile=case if case in ("lorentz", "doppler") else "voigt",
              continuum={"voigt": "mt_ckd", "mixing": "mt_ckd",
                         "doppler": "h2o_empirical"}.get(case, "none"),
              line_mixing=lm if case == "mixing" else None)
    if route == "pallas_plan":
        kw.update(engine="pallas",
                  plan=od.make_od_plan(lines, iso, SLICE_AXIS, state))
    elif route == "pallas":
        kw.update(engine="pallas", pallas_opts=(
            {"n_weideman": 24} if dtype == torch.float64 else None))
    got = od.compute_od_layers(lines, iso, SLICE_AXIS, state, **kw)
    assert got.dtype == dtype
    got = got.numpy()
    assert got.shape == want.shape == (SLICE_LAYERS.size, SLICE_AXIS.size)
    assert np.abs(got - want).max() <= bound * np.abs(want).max(), \
        np.abs(got - want).max() / np.abs(want).max()


def test_compute_od_layers_sdvoigt_ht_and_refused(slice_case, iso_tables):
    """The reference engine's SD-Voigt and HT (``NotImplementedError``
    naming ROADMAP M13 until they were ported) against JAX's jnp engine on
    the slice band's 720-721 cm^-1, float64, within 1e-12 of the peak; a
    prebuilt plan takes Voigt and kernel options only, as JAX's route
    refuses the rest."""
    store, atm, port = slice_case
    lines, iso, state = port[torch.float64]
    axis = SLICE_AXIS[800:1001]
    for profile in ("sdvoigt", "ht"):
        want = np.asarray(j_od.compute_od_layers(
            store, iso_tables, jnp.asarray(axis), atm, profile=profile))
        got = od.compute_od_layers(lines, iso, axis, state,
                                   profile=profile).numpy()
        assert got.shape == want.shape == (SLICE_LAYERS.size, axis.size)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
    lines, iso, state = port[torch.float32]
    plan = od.make_od_plan(lines, iso, SLICE_AXIS, state)
    with pytest.raises(ValueError, match="Voigt only"):
        od.compute_od_layers(lines, iso, SLICE_AXIS, state, engine="pallas",
                             plan=plan, profile="lorentz")
    with pytest.raises(ValueError, match="plan construction"):
        od.compute_od_layers(lines, iso, SLICE_AXIS, state, engine="pallas",
                             plan=plan, pallas_opts={"tile": 512})


@pytest.mark.parametrize("model", ["none", "mt_ckd", "h2o_empirical",
                                   "rayleigh", "empirical"])
def test_continuum_od_matches_jax(model):
    """Each pointwise continuum model against JAX's continuum_od, float64,
    all 66 StdAtmos layers over 500-1700 cm^-1 (the CO2 far-wing table, the
    O2 CIA band's red side and the H2O tables): within 1e-12 relative of
    the peak, with scale factors that weight every slot."""
    atm = j_std_atmosphere()
    state = AtmosphericState.from_numpy(
        **{f: np.asarray(getattr(atm, f)) for f in STATE},
        mol_ids=atm.mol_ids, **F64)
    nu = np.linspace(500.0, 1700.0, 2401)
    cf = np.array([1.1, 0.9, 1.2, 1.0, 0.8, 1.3, 0.7])
    want = np.asarray(j_continuum.continuum_od(jnp.asarray(nu), atm, model,
                                               continuum_factors=cf))
    got = continuum.continuum_od(torch.as_tensor(nu), state, model,
                                 continuum_factors=cf).numpy()
    assert got.shape == want.shape == (66, nu.size)
    assert np.abs(got - want).max() <= 1e-12 * max(np.abs(want).max(),
                                                   1e-300)


def test_make_od_fn_pointwise_continuum(slice_case):
    """make_od_fn takes the pointwise models (continuum='h2o_empirical'
    raised before): it adds continuum_od of the model to the line OD,
    float64, within 1e-12 of the continuum's peak."""
    lines, iso, state = slice_case[2][torch.float64]
    args = (state.T, state.p, state.pl, state.vmr)
    bare = od.make_od_fn(lines, iso, SLICE_AXIS, state)(*args)
    with_c = od.make_od_fn(lines, iso, SLICE_AXIS, state,
                           continuum="h2o_empirical")(*args)
    want = continuum.continuum_od(torch.as_tensor(SLICE_AXIS), state,
                                  "h2o_empirical")
    assert want.abs().max() > 0.0
    assert (with_c - bare - want).abs().max() <= 1e-12 * want.abs().max() \
        + 1e-12 * bare.abs().max()


def test_continuum_registry_and_factors():
    """register_continuum adds a model continuum_od runs; the 7-factor
    convention is checked (another length raises, an O3 factor for
    'mt_ckd' warns that it has no effect)."""
    state = AtmosphericState.from_numpy(
        **{f: np.asarray(getattr(j_std_atmosphere(), f)) for f in STATE},
        **F64)
    nu = torch.linspace(700.0, 800.0, 11, dtype=torch.float64)
    continuum.register_continuum(
        "test_flat", lambda nu, T, p, vmr, mol_ids, pl, cf:
        cf[0] * torch.ones_like(T) * torch.ones_like(nu))
    try:
        out = continuum.continuum_od(nu, state, "test_flat",
                                     continuum_factors=[2.0] + [1.0] * 6)
        assert out.shape == (66, 11) and bool((out == 2.0).all())
    finally:
        del continuum.CONTINUUM_MODELS["test_flat"]
    with pytest.raises(ValueError, match="7 elements"):
        continuum.continuum_od(nu, state, "mt_ckd",
                               continuum_factors=[1.0] * 6)
    with pytest.warns(UserWarning, match="O3"):
        continuum.continuum_od(nu, state, "mt_ckd",
                               continuum_factors=[1, 1, 1, 2, 1, 1, 1])


def test_xsect_from_params_profile_is_positional(synthetic, iso_tables):
    """JAX's (grid, params, profile, chunk) order: a positional profile
    reaches the profile (Voigt, Lorentz and Doppler differ), and each
    profile matches the JAX jnp engine, float64, within 1e-12 of peak on
    570-580 cm^-1, SD-Voigt (pcqsdhc, on its own line parameters)
    included."""
    j_store, _, store64 = synthetic
    axis = GRID_AXIS[8000:12001]
    grid = torch.as_tensor(axis)
    iso = IsoTables.load(**F64)
    outs = {}
    for profile in ("voigt", "lorentz", "doppler", "sdvoigt"):
        p = compute_line_params(store64, iso, 250.0, 0.5, profile=profile)
        outs[profile] = got = xsect_from_params(grid, p, profile, 256)
        want = np.asarray(j_xsect(jnp.asarray(axis),
                                  j_params(j_store, iso_tables, 250.0, 0.5,
                                           profile=profile), profile))
        assert np.abs(got.numpy() - want).max() <= \
            1e-12 * np.abs(want).max()
    assert torch.equal(outs["sdvoigt"],
                       xsect_from_params(grid, p, profile="sdvoigt",
                                         chunk=256))
    assert not torch.equal(outs["voigt"], outs["lorentz"])
    assert not torch.equal(outs["voigt"], outs["doppler"])
    assert not torch.equal(outs["voigt"], outs["sdvoigt"])


# The JAX planner's options (ROADMAP queue 3 item 1): each held integer-exact
# against JAX's planner, through the planner and through make_od_fn
PLAN_OPTS = [dict(two_pass=False), dict(far_tile=1536), dict(far_block=48),
             dict(core_tile=384),
             dict(far_tile=768, far_block=32, core_tile=256)]


def _same_packed_plan(a, b):
    assert (a.tile, a.block, a.n_tiles, a.n_blocks, a.max_blocks) == \
        (b.tile, b.block, b.n_tiles, b.n_blocks, b.max_blocks)
    for f in ("starts", "counts", "k_line", "frac0", "gather"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f),
                                      err_msg=f)
    assert a.max_wing == b.max_wing


def _same_device_calls(got, want):
    """A builder's device passes against JAX's host calls: layers, mode,
    tile, block and the integer plan, slot for slot."""
    assert [c[2] for c in got] == [c[3] for c in want]
    for (lay, dplan, _), (j_lay, j_idx, j_plan, _) in zip(got, want):
        np.testing.assert_array_equal(lay.numpy(), np.asarray(j_lay))
        assert (dplan.tile, dplan.block, dplan.n_tiles) == \
            (j_plan.tile, j_plan.block, j_plan.n_tiles)
        for f in ("starts", "counts"):
            np.testing.assert_array_equal(getattr(dplan, f).numpy(),
                                          getattr(j_plan, f), err_msg=f)
        np.testing.assert_array_equal(dplan.k_line.numpy(),
                                      j_plan.k_line.reshape(-1))
        gather = j_plan.gather.reshape(-1)
        idx = np.asarray(j_idx)
        np.testing.assert_array_equal(
            dplan.line.numpy(),
            np.where(gather >= 0, idx[np.maximum(gather, 0)], -1))


@pytest.mark.parametrize("opts", PLAN_OPTS,
                         ids=lambda o: ",".join(f"{k}={v}"
                                                for k, v in o.items()))
def test_planning_options_match_jax(slice_case, iso_tables, opts):
    """``two_pass``, ``far_tile``, ``far_block`` and ``core_tile`` (which
    ``make_od_fn`` refused with ``TypeError``) plan the JAX planner's calls:
    the same passes, layers, lines and plans, integer-exact, in
    ``_build_od_calls`` and in ``make_od_fn``'s device passes."""
    store, atm, port = slice_case
    lines, iso, state = port[torch.float64]
    kw = dict(two_pass=True, far_tile=None, far_block=None,
              core_tile=None) | opts
    want = j_od._build_od_calls(
        *j_od._host_planning_views(store, iso_tables, atm),
        JGrid.from_axis(SLICE_AXIS), 0.0, 50.0, 8, 512, kw["two_pass"],
        kw["far_tile"], kw["far_block"], 4.0, kw["core_tile"], 16, "voigt")
    got = od._build_od_calls(
        *od._host_planning_views(lines, iso, state),
        UniformGrid.from_axis(SLICE_AXIS), 0.0, 50.0, 8, 512, 4.0,
        core_block=16, **kw)
    assert [c[3] for c in got] == [c[3] for c in want]
    assert ("full" in [c[3] for c in got]) == (not kw["two_pass"])
    for (lay, idx, plan, _), (j_lay, j_idx, j_plan, _) in zip(got, want):
        np.testing.assert_array_equal(lay, np.asarray(j_lay))
        np.testing.assert_array_equal(idx, np.asarray(j_idx))
        _same_packed_plan(plan, j_plan)
    fn = od.make_od_fn(lines, iso, SLICE_AXIS, state, fast_rcp=False,
                       **opts)
    _same_device_calls(fn.calls, want)


def test_coarse_route_options_match_jax(iso_tables):
    """``far_method`` and ``near_width`` in ``make_od_fn`` (25 cm^-1
    absolute wings at 0.01 cm^-1, R = 16): 'auto' and 'coarse' plan JAX's
    coarse-far calls with a near width of 10 cm^-1 (wider than the
    41 R dx = 6.56 floor, so it sizes the plans) and the classic core
    passes; 'classic' JAX's classic calls; 'coarse' where the wing does
    not clear the disjointness bound raises ``ValueError``."""
    j_store = j_synthetic(300, nu_min=470.0, nu_max=710.0, seed=9)
    store = synthetic_lines(300, nu_min=470.0, nu_max=710.0, seed=9, **F64)
    j_atm = j_std_atmosphere()
    j_atm = j_atm.replace(**{f: getattr(j_atm, f)[SLICE_LAYERS]
                             for f in STATE})
    state = AtmosphericState.from_numpy(
        **{f: np.asarray(getattr(j_atm, f)) for f in STATE},
        mol_ids=j_atm.mol_ids, **F64)
    iso = IsoTables.load(**F64)
    axis = arange_drift_free(500.0, 680.0, 0.01)
    jg = JGrid.from_axis(axis)
    views = j_od._host_planning_views(j_store, iso_tables, j_atm)
    nw = j_od._coarse_near_width(16, jg.dx, 10.0)
    assert nw == 10.0
    _, j_coarse, j_corr = j_od._build_coarse_far_calls(
        views[0], jg, 25.0, "voigt", 16, nw, 512,
        j_od._coarse_tile_corr(jg, 16, nw, 25.0))
    j_classic = j_od._build_od_calls(*views, jg, 25.0, 50.0, 8, 512, True,
                                     None, None, 4.0, None, 16, "voigt")
    for method in ("auto", "coarse"):
        fn = od.make_od_fn(store, iso, axis, state, wing_abs=25.0,
                           coarse_r=16, near_width=10.0, far_method=method)
        for got, want in ((fn.coarse_calls, j_coarse),
                          (fn.corr_calls, j_corr)):
            assert [c[2] for c in got] == [c[2] for c in want]
            for (_, dplan, _), (j_idx, j_plan, _) in zip(got, want):
                assert (dplan.tile, dplan.block, dplan.n_tiles) == \
                    (j_plan.tile, j_plan.block, j_plan.n_tiles)
                np.testing.assert_array_equal(dplan.starts.numpy(),
                                              j_plan.starts)
                np.testing.assert_array_equal(dplan.k_line.numpy(),
                                              j_plan.k_line.reshape(-1))
        _same_device_calls(fn.calls, [c for c in j_classic
                                      if c[3] == "core"])
    fn = od.make_od_fn(store, iso, axis, state, wing_abs=25.0, coarse_r=16,
                       near_width=10.0, far_method="classic")
    assert not fn.coarse_calls and not fn.corr_calls
    _same_device_calls(fn.calls, j_classic)
    with pytest.raises(ValueError, match="far_method='coarse'"):
        od.make_od_fn(store, iso, axis, state, wing_abs=25.0, coarse_r=16,
                      near_width=40.0, far_method="coarse")


@pytest.mark.parametrize("opts", [dict(two_pass=False), dict(far_tile=1536),
                                  dict(far_block=48), dict(core_tile=384),
                                  dict(far_method="classic", near_width=8.0,
                                       fast_rcp=False)],
                         ids=lambda o: ",".join(o))
def test_compute_od_layers_pallas_opts_match_jax(slice_case, slice_reference,
                                                 opts):
    """``compute_od_layers(engine='pallas', pallas_opts=...)`` passes each
    planning option through to ``make_od_fn`` (a ``TypeError`` before) and
    matches JAX's float64 jnp engine within 1e-12 of the peak (float64
    plain versions, 24 Weideman terms; measured 7.65e-13)."""
    lines, iso, state = slice_case[2][torch.float64]
    want = slice_reference[0]["voigt"]
    got = od.compute_od_layers(lines, iso, SLICE_AXIS, state, engine="pallas",
                               continuum="mt_ckd",
                               pallas_opts={"n_weideman": 24, **opts}).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_fast_rcp_and_bad_sizes_are_refused(slice_case):
    """``fast_rcp`` (the TPU kernels' approximate reciprocal) is taken by
    every builder, True by default as in JAX's, planning the same passes
    either way (it selects the kernels' instantiation, not the plans), and
    by the prebuilt-plan route's ``pallas_opts``, whose ``interpret`` still
    raises ``NotImplementedError``; a tile or block that is not a positive
    integer raises ``ValueError`` naming the constraint, while 0 keeps the
    planner's choice, as JAX's ``far_tile or ...``."""
    lines, iso, state = slice_case[2][torch.float32]
    plans = lambda fn: [(c[1].tile, c[1].block, c[2])  # noqa: E731
                        for c in fn.all_calls()]
    default = od.make_od_fn(lines, iso, SLICE_AXIS, state)
    assert default.fast_rcp
    assert not od.make_od_fn(lines, iso, SLICE_AXIS, state,
                             fast_rcp=False).fast_rcp
    assert plans(od.make_od_fn(lines, iso, SLICE_AXIS, state,
                               fast_rcp=False)) == plans(default)
    for build in (od.make_xsect_fn, od.make_ht_fn):
        for fast in (True, False):
            assert build(lines, iso, SLICE_AXIS, [296.0], [1.0],
                         fast_rcp=fast).fast_rcp is fast
    assert od.make_od_ht_fn(lines, iso, SLICE_AXIS, state).fast_rcp
    plan = od.make_od_plan(lines, iso, SLICE_AXIS, state)
    with pytest.raises(NotImplementedError, match="interpret"):
        od.compute_od_layers(lines, iso, SLICE_AXIS, state, engine="pallas",
                             plan=plan, pallas_opts={"interpret": True})
    for bad in (dict(far_tile=-512), dict(core_tile=256.0),
                dict(far_block=-8)):
        with pytest.raises(ValueError, match="positive integer"):
            od.make_od_fn(lines, iso, SLICE_AXIS, state, **bad)
    fn = od.make_od_fn(lines, iso, SLICE_AXIS, state, fast_rcp=False)
    zero = od.make_od_fn(lines, iso, SLICE_AXIS, state, far_tile=0,
                         far_block=0, core_tile=0)
    assert [(c[1].tile, c[1].block, c[2]) for c in zero.calls] == \
        [(c[1].tile, c[1].block, c[2]) for c in fn.calls]
