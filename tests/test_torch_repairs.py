"""The port's public surface against radtxfr_tpu's, and K1's window culling
rule against the plain version's window mask.

* Every name a JAX subpackage ``__init__`` (and the top-level one) exports
  and the port's module at the same path defines is exported by the port's
  subpackage, and importing them loads neither JAX nor ``radtxfr_tpu``
  (checked in a fresh interpreter: this process has JAX loaded).
* The public members ROADMAP queue 3 item 2 found missing
  (``LineStore.n_lines``/``select_molecules``, ``TUD.squeezed``,
  ``downwelling_angles``, ``AtmosphericState.replace``,
  ``planckian(wavelength=True)``, ``compute_line_params(abundance_ratio=)``,
  ``group_layers_by_wing``) against the JAX ones in float64.
* ``tud`` takes the JAX CLI's ``--engine`` and ``--partition``; ``--engine
  jnp`` runs the reference engine and matches the JAX CLI's.
* K1 (``csrc/k1_skeleton.cuh::window_range``) keeps a staged (slot, layer)
  pair only where the integer range [k_line + floor(frac0 - wingu) - 2,
  k_line + ceil(frac0 + wingu) + 2] meets the CTA's points: that range must
  hold every grid index at which the plain version's float32 window test
  passes; in the core pass (``core_range``) every index where that test and
  hum1_wei's |x| + y < 15 both pass, the only points core adds to.
* K7 on ``make_od_plan``'s shared-block plan (wings capped by the plan's
  ``wcap``) culls by the same rule; in ``full`` a span outside
  ``core_range`` runs the asymptotic form only, so ``core_range`` must hold
  every in-window index inside |x| + y < 15.
* K3 keeps a (slot, (direction, layer) row) pair only where the row is
  live in ``fused_xsect.live_directions`` and the pair's coefficients are
  not all zero: every pair and direction with a non-zero tangent whose
  float window passes must be kept, with its in-window (and in-core)
  indices inside its ranges.
* K5 and K6 (``csrc/fused_ht.cu``) cull by the same window rule on the HT
  builders' packed plans; a span outside a pair's Weideman range
  (``ht_near_range``: closed forms for PART1 and for PART4 with c2t and
  csqrtY real) runs both CPF points in the asymptotic form without
  PART4's CPF3 test, so the range must hold every in-window point that
  pcqsdhc's per-point test sends to Weideman, and no point outside it may
  take CPF3. K6's rows are ``live_directions``' (direction, layer) rows.
* The single-device modules ported last: ``partition_sum_ratio`` over
  70-3000 K for every isotopologue row, ``load_mt_ckd_tables`` on an HDF5
  file and ``set_h2o_tables`` moving both packages' ``mt_ckd`` continuum
  (pointwise and layered) the same way, ``branch_profile_full_w`` and
  ``lines.golden``'s anchors, against JAX's.
* K4 (``csrc/fused_xsect_jvp.cu``) culls by the same window rule on the
  HT Jacobian's and the differentiable SD-Voigt OD's ``sdvoigt`` passes;
  a span outside a pair's Weideman range (``sd_near_range``: K5's PART4
  closed form with P = Re X + c^2, R = 15 + c) runs both CPF points in the
  asymptotic form, so the range must hold every in-window point at which
  either CPF point's float32 region test takes Weideman. K4's rows are
  ``live_directions``' (direction, layer) rows.
"""

import ast
import json
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from radtxfr_tpu_torch.cli.main import build_parser, run_tud
from port_fixtures import one_torch_thread  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SUBPACKAGES = ("core", "lines", "kernels", "atmos", "products", "sensor",
               "io", "dist", "scene", "utils")


def _jax_exports(rel):
    """[(module, name)] of ``radtxfr_tpu/<rel>/__init__.py``, read as
    source (importing it loads JAX); ``*`` from a module expands to its
    upper-case assignments; a submodule imported by name is (None, name)."""
    pkg = os.path.join(ROOT, "radtxfr_tpu", *rel.split("/"))
    tree = ast.parse(open(os.path.join(pkg, "__init__.py")).read())
    out = []
    for node in tree.body:
        if not isinstance(node, ast.ImportFrom) or node.level != 1:
            continue
        for alias in node.names:
            if alias.name != "*":
                out.append((node.module, alias.name))
                continue
            src = ast.parse(open(os.path.join(
                pkg, *node.module.split(".")) + ".py").read())
            out += [(node.module, t.id) for n in src.body
                    if isinstance(n, ast.Assign) for t in n.targets
                    if isinstance(t, ast.Name) and t.id.isupper()]
    return out


_CHECK = """
import importlib, json, sys
wanted = json.loads(sys.argv[1])
res = {}
for rel, pairs in wanted.items():
    pkg = "radtxfr_tpu_torch" + ("." + rel.replace("/", ".") if rel else "")
    sub = importlib.import_module(pkg)
    ported, missing = [], []
    for mod, name in pairs:
        try:
            m = importlib.import_module(pkg + "." + (mod or name))
        except ImportError:
            continue
        if mod is None:
            # "from . import <submodule>": the subpackage exposes it
            ported.append(name)
            if getattr(sub, name, None) is not m:
                missing.append(name)
        elif hasattr(m, name):
            ported.append(name)
            if getattr(sub, name, None) is not getattr(m, name):
                missing.append(name)
    res[rel] = {"ported": ported, "missing": missing}
res["loaded"] = sorted(k for k in sys.modules
                       if k.split(".")[0] in ("jax", "radtxfr_tpu"))
print(json.dumps(res))
"""


@pytest.fixture(scope="module")
def exports():
    wanted = {rel: _jax_exports(rel) for rel in SUBPACKAGES}
    wanted[""] = _jax_exports("")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    run = subprocess.run([sys.executable, "-c", _CHECK, json.dumps(wanted)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         check=True)
    return json.loads(run.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("rel", ("",) + SUBPACKAGES)
def test_subpackage_exports_the_ported_names(exports, rel):
    got = exports[rel]
    assert got["ported"], f"no ported name of radtxfr_tpu/{rel}"
    assert not got["missing"], got["missing"]
    # and nothing of JAX or of the JAX package came with them
    assert exports["loaded"] == []


@pytest.mark.parametrize("engine,partition", [("auto", None),
                                              ("pallas", "equal"),
                                              ("pallas", "weighted")])
def test_tud_takes_engine_and_partition(engine, partition):
    argv = ["tud", "--derived", "--engine", engine]
    if partition:
        argv += ["--partition", partition]
    args = build_parser().parse_args(argv)
    assert args.engine == engine
    assert args.partition == (partition or "weighted")


def test_tud_engine_jnp_runs(tmp_path):
    """``tud --engine jnp`` (it raised, naming ROADMAP queue 1 item 3)
    runs the reference engine: on 718-718.5 cm^-1, one member, against
    the JAX CLI's ``--engine jnp`` (float32, x64 off) within the CLI's
    1e-5 of each product's peak, and no kernel pass is planned."""
    import h5py
    import jax

    from radtxfr_tpu.cli.main import build_parser as j_build_parser

    argv = ["tud", "--derived", "--continuum", "mt_ckd", "--numin", "718",
            "--numax", "718.5", "--dv", "0.005", "--n-atmos", "1",
            "--batch", "1", "--engine", "jnp"]
    x_lo, out = run_tud(build_parser().parse_args(argv + ["--device",
                                                          "cpu"]), "cpu")
    j_args = j_build_parser().parse_args(argv + ["--output",
                                                 str(tmp_path / "j.h5")])
    jax.config.update("jax_enable_x64", False)
    try:
        j_args.fn(j_args)
    finally:
        jax.config.update("jax_enable_x64", True)
    with h5py.File(tmp_path / "j.h5", "r") as f:
        np.testing.assert_array_equal(x_lo, f["X"][...])
        for k, name in (("tau", "tau"), ("Lu", "La"), ("Ld", "Ld")):
            want = f[name][...]
            assert out[k].shape == want.shape, k
            assert np.abs(out[k] - want).max() <= \
                1e-5 * np.abs(want).max(), k


def _window_range(f0, wingu):
    """K1's window_range (csrc/fused_xsect.cu), in float32."""
    f0 = np.asarray(f0, dtype=np.float32)
    wingu = np.asarray(wingu, dtype=np.float32)
    with np.errstate(invalid="ignore"):
        wide = ~(wingu <= np.float32(4194304.0))
        lo = np.floor(f0 - wingu).astype(np.int64) - 2
        hi = np.ceil(f0 + wingu).astype(np.int64) + 2
    return (np.where(wide, -(1 << 30), lo), np.where(wide, 1 << 30, hi))


def _core_range(f0, ds, xs, y, lo, hi):
    """K1's core_range, in float32: the window range cut to the indices
    that can lie in |x| + y < 15."""
    f32 = np.float32
    r = (f32(15.0) - y) / xs
    clo, chi = _window_range(f0 + ds, r * f32(1.0001) + f32(1.0))
    empty = ~(r > 0)
    return (np.where(empty, 1, np.maximum(lo, clo)),
            np.where(empty, 0, np.minimum(hi, chi)))


@pytest.fixture(scope="module")
def production_passes():
    from radtxfr_tpu_torch.atmos.profile import std_atmosphere
    from radtxfr_tpu_torch.core.grid import arange_drift_free
    from radtxfr_tpu_torch.kernels.linemixing_data import y_air_for_store
    from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist
    from radtxfr_tpu_torch.lines.store import IsoTables
    from radtxfr_tpu_torch.products.od import make_od_fn

    f32 = torch.float32
    store = derived_lwir_linelist(693.0, 748.0, device="cpu", dtype=f32)
    base = std_atmosphere(device="cpu", dtype=f32)
    fn = make_od_fn(store, IsoTables.load(device="cpu", dtype=f32),
                    arange_drift_free(718.0, 723.0, 0.0005), base,
                    line_mixing={"y_air": y_air_for_store(
                        store.host_view())})
    prm, _ = fn.line_params(base.T, base.p, base.pl, base.vmr)
    return fn, prm


def _check_cull(dp, prm, rows, mode, live=None):
    """Assert, for the (slot, layer) pairs of the layers ``rows`` of the
    plan ``dp`` (``live(li, g)``: the pairs' lines of layer ``li`` a kernel
    keeps, None all), that the integer window range holds every grid index
    at which the plain version's float32 window test passes (``core``: and
    |x| + y < 15; ``full``: the in-window indices in |x| + y < 15 also lie
    in ``core_range``); the (in-window indices, kept indices, pairs)."""
    line = dp.line.numpy()
    k_line = dp.k_line.numpy().astype(np.int64)
    frac0 = dp.frac0.numpy()
    tile_of = np.repeat(np.arange(dp.n_tiles),
                        dp.counts.numpy().astype(np.int64) * dp.block)
    s_all = np.nonzero(line[:tile_of.size] >= 0)[0]
    n_in = n_kept = n_pairs = 0
    for li in rows:
        s = s_all if live is None else s_all[live(li, line[s_all])]
        g, t = line[s], tile_of[s]
        k = (t[:, None] * dp.tile + np.arange(dp.tile)[None, :])
        # the plain version's u and mask, float32 (fused_xsect._plain_steps)
        u = ((k - k_line[s][:, None]).astype(np.float32)
             - frac0[s][:, None])
        w = np.minimum(prm.wing.numpy()[li, g], dp.wcap.numpy()[s])
        wingu = (torch.as_tensor(w) / dp.dx).numpy()[:, None]
        mask = (u > -wingu) & (u <= wingu) & (k < dp.n_out)
        lo, hi = _window_range(frac0[s], wingu[:, 0])
        d = k - k_line[s][:, None]
        inside = lambda lo, hi: (  # noqa: E731
            (d >= lo[:, None]) & (d <= hi[:, None]) & (k < dp.n_out))
        if mode in ("core", "full"):
            # line_const's Voigt constants, float32 as in the kernel
            cte = (torch.tensor(0.8325546111576977, dtype=torch.float32)
                   / prm.gamma_d[li, g]).numpy()
            ds = (prm.shift0[li, g] / dp.dx).numpy()
            xs = (dp.dx * torch.as_tensor(cte)).numpy()
            y = (prm.gamma_0[li, g] * torch.as_tensor(cte)).numpy()
            x = (u - ds[:, None]) * xs[:, None]
            core = (np.abs(x) + y[:, None]) < np.float32(15.0)
            clo, chi = _core_range(frac0[s], ds, xs, y, lo, hi)
            if mode == "core":
                mask &= core
                lo, hi = clo, chi
            else:
                assert not (mask & core & ~inside(clo, chi)).any(), (mode,
                                                                     li)
        kept = inside(lo, hi)
        assert not (mask & ~kept).any(), (mode, li)
        n_in += int(mask.sum())
        n_kept += int(kept.sum())
        n_pairs += mask.shape[0]
    return n_in, n_kept, n_pairs


@pytest.mark.parametrize("mode", ("asym", "core", "mix"))
def test_window_range_holds_the_plain_window(production_passes, mode):
    fn, prm = production_passes
    calls = [c for c in fn.calls if c[2] == mode]
    assert calls
    n_in = n_kept = n_pairs = 0
    for lay, dp, _ in calls:
        a, b, c = _check_cull(dp, prm, lay.numpy(), mode)
        n_in, n_kept, n_pairs = n_in + a, n_kept + b, n_pairs + c
    # the range is tight: at most 6 indices more than the window a pair
    # (core: than the window's part in |x| + y < 15, with its 1e-4 margin)
    assert n_in > 0 and n_kept - n_in <= 6 * n_pairs


@pytest.fixture(scope="module")
def od_plan_case():
    """make_od_plan's shared-block plan on 718-723 cm^-1 at 5e-4 (derived
    list, standard atmosphere) on the CPU, its float32 Voigt parameters."""
    from radtxfr_tpu_torch.atmos.profile import std_atmosphere
    from radtxfr_tpu_torch.core.grid import arange_drift_free
    from radtxfr_tpu_torch.kernels.fused_xsect import device_plan
    from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist
    from radtxfr_tpu_torch.lines.store import IsoTables
    from radtxfr_tpu_torch.products.od import (_line_species_cols,
                                               layer_line_params,
                                               make_od_plan)

    f32 = torch.float32
    store = derived_lwir_linelist(693.0, 748.0, device="cpu", dtype=f32)
    iso = IsoTables.load(device="cpu", dtype=f32)
    base = std_atmosphere(device="cpu", dtype=f32)
    plan = make_od_plan(store, iso, arange_drift_free(718.0, 723.0, 0.0005),
                        base)
    prm = layer_line_params(store, iso, base,
                            _line_species_cols(store.host_view(),
                                               base.mol_ids))
    n_lay, n_lines = prm.strength.shape
    dp = device_plan(plan, np.arange(n_lines), None, device="cpu")
    return dp, prm, n_lay


@pytest.mark.parametrize("mode", ("full", "core"))
def test_k7_window_range_holds_the_plain_window(od_plan_case, mode):
    """K7's cull on make_od_plan's plan, whose wing cap is the widest
    layer's wing: every layer's in-window (core: in-core) indices lie in
    the ranges, and the cap leaves most of a tile's slot-points outside
    them in the upper layers."""
    dp, prm, n_lay = od_plan_case
    n_in, n_kept, n_pairs = _check_cull(dp, prm, range(n_lay), mode)
    assert n_in > 0 and n_kept - n_in <= 6 * n_pairs
    slot_points = int(dp.counts.sum()) * dp.block * dp.tile * n_lay
    assert n_kept < slot_points / 2


@pytest.fixture(scope="module")
def jacobian_passes():
    """The differentiable builder's full passes on 718-723 cm^-1 at 5e-4
    (CPU, float32) and the line-parameter tangents of 8 one-hot T
    directions (layers 24-31, one Jacobian batch) and of a T direction over
    all layers."""
    from radtxfr_tpu_torch.atmos.profile import std_atmosphere
    from radtxfr_tpu_torch.core.grid import arange_drift_free
    from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist
    from radtxfr_tpu_torch.lines.store import IsoTables
    from radtxfr_tpu_torch.products.od import make_od_fn

    f32 = torch.float32
    store = derived_lwir_linelist(693.0, 748.0, device="cpu", dtype=f32)
    base = std_atmosphere(device="cpu", dtype=f32)
    fn = make_od_fn(store, IsoTables.load(device="cpu", dtype=f32),
                    arange_drift_free(718.0, 723.0, 0.0005), base,
                    differentiable=True)
    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr

    def prm_of(T_):
        q = fn.line_params(T_, p, pl, vmr)[0]
        return q.shift0, q.strength, q.gamma_d, q.gamma_0

    n = base.n_layers
    sets = {"one-hot": torch.eye(n)[24:32],
            "dense": torch.linspace(0.5, 1.5, n)[None]}
    tans = {k: torch.func.vmap(lambda v: torch.func.jvp(
        prm_of, (T,), (v,))[1])(V) for k, V in sets.items()}
    return fn, fn.line_params(T, p, pl, vmr)[0], tans


@pytest.mark.parametrize("kind", ("one-hot", "dense"))
def test_k3_keeps_every_live_pair_in_its_window(jacobian_passes, kind):
    """K3's rows and kept pairs: a (direction, layer) row is live in
    live_directions exactly where a tangent of the direction is non-zero on
    the layer, and each live row's pairs with a non-zero tangent keep every
    in-window index inside their window range and every in-window index in
    |x| + y < 15 inside core_range (the one-hot batch: one live row a
    direction)."""
    from radtxfr_tpu_torch.kernels.fused_xsect import live_directions

    fn, prm, tans = jacobian_passes
    tans = tans[kind]
    nd, n_lay = tans[0].shape[0], tans[0].shape[1]
    live = live_directions(tans, n_lay).numpy()
    nz = np.stack([(t != 0).numpy() for t in tans]).any(axis=0)
    assert (live == nz.any(axis=2)).all()
    if kind == "one-hot":
        assert (live.sum(axis=1) == 1).all()
    n_in = n_kept = n_pairs = 0
    for lay, dp, mode in fn.calls:
        assert mode == "full"
        for d in range(nd):
            rows = [li for li in lay.numpy() if live[d, li]]
            a, b, c = _check_cull(dp, prm, rows, "full",
                                  live=lambda li, g: nz[d, li, g])
            n_in, n_kept, n_pairs = n_in + a, n_kept + b, n_pairs + c
    assert n_in > 0 and n_kept - n_in <= 6 * n_pairs


@pytest.fixture(scope="module")
def ht_passes():
    """The layered HT OD's ``ht`` passes (make_od_ht_fn, standard
    atmosphere) on 800-805 cm^-1 at 0.0025 on the CPU in float32: 200
    synthetic lines, 40% with live HT columns (eta real, nuVC), 40% with
    SD_air = 0 (PART1 among the HT lines); the HT parameters, and the
    line-parameter tangents of 8 one-hot T directions (layers 24-31) and
    of a T direction over all layers."""
    from radtxfr_tpu_torch.atmos.profile import std_atmosphere
    from radtxfr_tpu_torch.core.grid import arange_drift_free
    from radtxfr_tpu_torch.lines.store import IsoTables
    from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
    from radtxfr_tpu_torch.products.od import make_od_ht_fn

    f32 = torch.float32
    store = synthetic_lines(200, nu_min=790.0, nu_max=815.0, seed=77,
                            sd_zero_frac=0.4, device="cpu", dtype=f32)
    rng = np.random.default_rng(5)
    live = rng.random(200) < 0.4
    extras = {"nu_HT_air": rng.uniform(0.01, 0.05, 200) * live,
              "kappa_HT_air": rng.uniform(0.0, 1.0, 200) * live,
              "eta_HT_air": rng.uniform(0.1, 0.3, 200) * live}
    base = std_atmosphere(device="cpu", dtype=f32)
    fn = make_od_ht_fn(store, IsoTables.load(device="cpu", dtype=f32),
                       arange_drift_free(800.0, 805.0, 0.0025), base,
                       extras=extras, differentiable=True)
    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr

    def prm_of(T_):
        q = fn.line_params(T_, p, pl, vmr)
        return (q.strength, *q.ht_consts)

    n = base.n_layers
    sets = {"one-hot": torch.eye(n)[24:32],
            "dense": torch.linspace(0.5, 1.5, n)[None]}
    tans = {k: torch.func.vmap(lambda v: torch.func.jvp(
        prm_of, (T,), (v,))[1])(V) for k, V in sets.items()}
    calls = [c for c in fn.calls if c[2] == "ht"]
    assert calls
    return calls, fn.line_params(T, p, pl, vmr), tans


def _ht_near_range(f0, k, dx, lo, hi):
    """csrc/fused_ht.cu::ht_near_range in float32: the grid offsets at which
    a CPF point of each pair (constants ``k``, 11 arrays) can take the
    Weideman branch, within the window range [lo, hi]; (lo', hi', kind):
    kind 1 PART1, 4 PART4 with c2t and csqrtY real (closed forms), 0 the
    whole window."""
    f32 = np.float32
    tiny = np.finfo(f32).tiny
    cte, k1, k2, c2r, c2i, cyr, cyi = (np.asarray(a, dtype=f32)
                                       for a in k[:7])
    dx = f32(dx)
    part1 = (c2r * c2r + c2i * c2i) == 0
    real = ~part1 & (c2i == 0) & (cyi == 0) & (cyr * cyr != 0)
    with np.errstate(all="ignore"):
        y = k1 * cte
        r1 = (f32(15.0) - y) / (dx * cte)
        ic2r = c2r / np.maximum(c2r * c2r, tiny)
        c2 = (f32(2.0) * cte) * c2r
        y0r = c2 / np.maximum(c2 * c2, tiny)
        P = np.abs(k1 * ic2r + y0r * y0r)
        R = f32(15.0) + np.abs(cyr)
        R2 = R * R
        r4 = (np.maximum((R2 - P) * (R2 + P), f32(0.0)) / (f32(2.0) * R2)
              / (np.abs(ic2r) * dx))
    empty = np.where(part1, ~(y < 15.0), ~(P < R2 * f32(1.001)))
    r = np.where(part1, r1, r4).astype(f32)
    clo, chi = _window_range(f0 + k2 / dx, r * f32(1.0001) + f32(1.0))
    closed = part1 | real
    kind = np.where(part1, 1, np.where(real, 4, 0))
    return (np.where(closed, np.where(empty, 1, np.maximum(lo, clo)), lo),
            np.where(closed, np.where(empty, 0, np.minimum(hi, chi)), hi),
            kind)


def _ht_point_regions(dnu, k):
    """pcqsdhc's per-point tests at ``dnu`` (float32, as the kernels round
    them): (Z1 in |x| + y < 15, Z2 in it, CPF3 taken) for PART4 pairs, the
    one w(Z) of PART1 pairs in the first; the HT constants ``k`` as float32
    tensors broadcastable against ``dnu``."""
    from radtxfr_tpu_torch.kernels.htp_real import _cinv, _cmul, _csqrt

    cte, k1, k2, c2r, c2i, cyr, cyi = k[:7]
    t0i = -dnu + k2
    part1 = (c2r * c2r + c2i * c2i) == 0.0
    in1 = (-(t0i * cte)).abs() + k1 * cte < 15.0
    one = torch.ones_like(c2r)
    ic2r, ic2i = _cinv(torch.where(part1, one, c2r),
                       torch.where(part1, 0 * one, c2i))
    Xr, Xi = _cmul(k1 + 0 * dnu, t0i, ic2r, ic2i)
    c2x = 2.0 * cte
    y0r, y0i = _cinv(c2x * c2r, c2x * c2i)
    Yr, Yi = _cmul(y0r, y0i, y0r, y0i)
    sr, si = _csqrt(Xr + Yr, Xi + Yi)
    cy0 = (cyr * cyr + cyi * cyi) == 0.0
    cr, ci = torch.where(cy0, one, cyr), torch.where(cy0, 0 * one, cyi)
    Z1r, Z1i = sr - cr, si - ci
    Z2r, Z2i = Z1r + 2.0 * cr, Z1i + 2.0 * ci
    w1 = Z1i.abs() + Z1r < 15.0
    w2 = Z2i.abs() + Z2r < 15.0
    s1 = torch.sqrt(Z1r * Z1r + Z1i * Z1i)
    s2 = torch.sqrt(Z2r * Z2r + Z2i * Z2i)
    use3 = (((s1 - s2).abs() <= 1.0) & (torch.maximum(s1, s2) > 8.0)
            & (torch.minimum(s1, s2) <= 8.0))
    return (torch.where(part1, in1, w1), torch.where(part1, False, w2),
            torch.where(part1, False, use3))


def test_ht_window_and_weideman_ranges_hold_the_point_tests(ht_passes):
    """K5's and K6's cull and span rule on the layered HT OD's packed plans:
    every (slot, layer, point) whose float32 window test passes lies in the
    pair's integer window; every such point that pcqsdhc's per-point test
    sends to Weideman (PART1's w(Z), both CPF points of PART4) lies in the
    pair's Weideman range where that range is closed-form; no in-window
    point outside it takes CPF3; and the closed forms do cull (most
    in-window points of the closed-form pairs lie outside them)."""
    calls, prm, _ = ht_passes
    consts = [c.numpy() for c in prm.ht_consts]
    n_in = n_wei = n_far = 0
    kinds = set()
    for lay, dp, _ in calls:
        line = dp.line.numpy()
        k_line = dp.k_line.numpy().astype(np.int64)
        frac0 = dp.frac0.numpy()
        tile_of = np.repeat(np.arange(dp.n_tiles),
                            dp.counts.numpy().astype(np.int64) * dp.block)
        s = np.nonzero(line[:tile_of.size] >= 0)[0]
        g, t = line[s], tile_of[s]
        k = t[:, None] * dp.tile + np.arange(dp.tile)[None, :]
        u = (k - k_line[s][:, None]).astype(np.float32) - frac0[s][:, None]
        dnu = torch.as_tensor(u) * np.float32(dp.dx)
        d = k - k_line[s][:, None]
        for li in lay.numpy():
            w = np.minimum(prm.wing.numpy()[li, g], dp.wcap.numpy()[s])
            wingu = (torch.as_tensor(w) / dp.dx).numpy()[:, None]
            mask = (u > -wingu) & (u <= wingu) & (k < dp.n_out)
            lo, hi = _window_range(frac0[s], wingu[:, 0])
            assert not (mask & ((d < lo[:, None]) | (d > hi[:, None]))).any()
            kc = [c[li, g] for c in consts]
            nlo, nhi, kind = _ht_near_range(frac0[s], kc, dp.dx, lo, hi)
            kinds |= set(np.unique(kind).tolist())
            near = (d >= nlo[:, None]) & (d <= nhi[:, None])
            w1, w2, use3 = (a.numpy() for a in _ht_point_regions(
                dnu, [torch.as_tensor(c)[:, None] for c in kc]))
            closed = (kind > 0)[:, None] & mask
            assert not (closed & (w1 | w2) & ~near).any(), li
            assert not (mask & use3 & ~near).any(), li
            n_in += int(closed.sum())
            n_wei += int((closed & (w1 | w2)).sum())
            n_far += int((closed & ~near).sum())
    assert {1, 4} <= kinds
    assert n_wei > 0 and n_far > n_in / 2, (n_in, n_wei, n_far)


@pytest.mark.parametrize("kind", ("one-hot", "dense"))
def test_k6_rows_are_the_live_directions(ht_passes, kind):
    """K6's rows: a (direction, layer) row is live in live_directions
    exactly where one of the direction's strength or HT-constant tangents
    is non-zero on the layer (the one-hot batch: one live row a
    direction), and every pair of a live row with a non-zero tangent keeps
    its in-window indices inside its window range."""
    from radtxfr_tpu_torch.kernels.fused_xsect import live_directions

    calls, prm, tans = ht_passes
    tans = tans[kind]
    nd, n_lay = tans[0].shape[0], tans[0].shape[1]
    live = live_directions(tans, n_lay).numpy()
    nz = np.stack([(t != 0).numpy() for t in tans]).any(axis=0)
    assert (live == nz.any(axis=2)).all()
    if kind == "one-hot":
        assert (live.sum(axis=1) == 1).all()
    n_in = n_kept = n_pairs = 0
    for lay, dp, _ in calls:
        for d in range(nd):
            rows = [li for li in lay.numpy() if live[d, li]]
            a, b, c = _check_cull(dp, prm, rows, "asym",
                                  live=lambda li, g: nz[d, li, g])
            n_in, n_kept, n_pairs = n_in + a, n_kept + b, n_pairs + c
    assert n_in > 0 and n_kept - n_in <= 6 * n_pairs


@pytest.fixture(scope="module")
def sd_passes():
    """The ``sdvoigt`` passes (CPU, float32, standard atmosphere) of the HT
    Jacobian's builder (make_od_ht_fn(differentiable=True): its 2,000
    synthetic lines over 780-840 cm^-1, seed 77, 40% SD_air = 0, 40% live
    HT columns) on 800-805 cm^-1 and of the differentiable SD-Voigt OD at
    full width's (make_od_fn(profile='sdvoigt'): the bench's 20,000 lines
    over 480-1520 cm^-1, seed 0) on 800-802 cm^-1, both at 0.0025; each
    with its line parameters and the (shift0, strength, gamma_d, gamma_0,
    gamma_2) tangents of 8 one-hot T directions (layers 24-31) and of a T
    direction over all layers."""
    from radtxfr_tpu_torch.atmos.profile import std_atmosphere
    from radtxfr_tpu_torch.core.grid import arange_drift_free
    from radtxfr_tpu_torch.lines.store import IsoTables
    from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
    from radtxfr_tpu_torch.products.od import make_od_fn, make_od_ht_fn

    f32 = torch.float32
    base = std_atmosphere(device="cpu", dtype=f32)
    iso = IsoTables.load(device="cpu", dtype=f32)
    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr
    rng = np.random.default_rng(5)
    rows = rng.random(2000) < 0.4
    extras = {"nu_HT_air": rng.uniform(0.01, 0.05, 2000) * rows,
              "kappa_HT_air": rng.uniform(0.0, 1.0, 2000) * rows,
              "eta_HT_air": rng.uniform(0.1, 0.3, 2000) * rows}
    ht = make_od_ht_fn(synthetic_lines(2000, nu_min=780.0, nu_max=840.0,
                                       seed=77, sd_zero_frac=0.4,
                                       device="cpu", dtype=f32),
                       iso, arange_drift_free(800.0, 805.0, 0.0025), base,
                       extras=extras, differentiable=True)
    sd = make_od_fn(synthetic_lines(20_000, nu_min=480.0, nu_max=1520.0,
                                    seed=0, device="cpu", dtype=f32),
                    iso, arange_drift_free(800.0, 802.0, 0.0025), base,
                    profile="sdvoigt", differentiable=True)
    n = base.n_layers
    sets = {"one-hot": torch.eye(n)[24:32],
            "dense": torch.linspace(0.5, 1.5, n)[None]}
    out = {}
    for label, fn, params in (
            ("ht jacobian", ht, lambda T_: ht.line_params(T_, p, pl, vmr)),
            ("sdvoigt od", sd, lambda T_: sd.line_params(T_, p, pl,
                                                         vmr)[0])):
        def prm_of(T_, params=params):
            q = params(T_)
            return q.shift0, q.strength, q.gamma_d, q.gamma_0, q.gamma_2

        tans = {k: torch.func.vmap(lambda v: torch.func.jvp(
            prm_of, (T,), (v,))[1])(V) for k, V in sets.items()}
        calls = [c for c in fn.calls if c[2] == "sdvoigt"]
        assert calls
        out[label] = (calls, params(T), tans)
    return out


def _sd_near_range(f0, prm, li, g, dx, lo, hi, shrink=1.0):
    """csrc/fused_xsect_jvp.cu::sd_pair's constants and sd_near_range in
    float32 for layer ``li``'s lines ``g``: the grid offsets at which a CPF
    point can take the Weideman branch, within the window range [lo, hi]
    (``shrink`` scales the radius); (lo', hi', kind, (s0, 1/Gamma2, aa,
    c)): kind 1 the closed form, 0 the whole window (near tangency)."""
    f32 = np.float32
    s0, gd, g0, g2r = (getattr(prm, k)[li, g].numpy().astype(f32)
                       for k in ("shift0", "gamma_d", "gamma_0", "gamma_2"))
    dx = f32(dx)
    with np.errstate(all="ignore"):
        cte = (f32(1.0) / gd) * f32(0.8325546111576977)
        g2 = np.maximum(g2r, f32(1e-4) * g0 + f32(1e-12))
        inv_g2 = f32(1.0) / g2
        xr = (g0 - f32(1.5) * g2) * inv_g2
        cc = (f32(1.0) / (cte * g2)) * f32(0.5)
        aa = xr + cc * cc
        P = np.abs(aa)
        R = f32(15.0) + cc
        R2 = R * R
        r = ((R2 - P) * (R2 + P) / (f32(2.0) * R2) / (inv_g2 * dx)
             * f32(shrink))
    empty = P >= R2 * f32(1.001)
    whole = ~empty & ~(P <= f32(0.9) * R2)
    clo, chi = _window_range(f0 + s0 / dx, r * f32(1.0001) + f32(1.0))
    return (np.where(empty, 1, np.where(whole, lo, np.maximum(lo, clo))),
            np.where(empty, 0, np.where(whole, hi, np.minimum(hi, chi))),
            np.where(whole, 0, 1), (s0, inv_g2, aa, cc))


def _sd_point_regions(u, dx, s0, inv_g2, aa, cc):
    """sd_point's S and sd_k_grads' region tests in float32 at the offsets
    ``u`` (points along axis 1) of pairs with the given constants: whether
    Z1 = S - c and Z2 = S + c lie in |x| + y < 15."""
    f32 = np.float32
    col = lambda a: a[:, None]  # noqa: E731
    with np.errstate(all="ignore"):
        xi = (col(s0) - u * f32(dx)) * col(inv_g2)
        r = np.sqrt(col(aa) * col(aa) + xi * xi)
        us = np.sqrt(np.maximum((r + col(aa)) * f32(0.5), f32(0.0)))
        vs = np.sqrt(np.maximum((r - col(aa)) * f32(0.5), f32(0.0)))
        return ((vs + (us - col(cc))) < f32(15.0),
                (vs + (us + col(cc))) < f32(15.0))


@pytest.mark.parametrize("label", ("ht jacobian", "sdvoigt od"))
def test_k4_window_and_weideman_ranges_hold_the_point_tests(sd_passes,
                                                            label):
    """K4's cull and span rule on the sdvoigt passes' plans: every (slot,
    layer, point) whose float32 window test passes lies in the pair's
    integer window; every such point at which either CPF point's float32
    region test takes Weideman lies in the pair's Weideman range; the
    closed form culls most in-window points of its pairs; and a radius 10%
    tighter would miss some Weideman point."""
    calls, prm, _ = sd_passes[label]
    n_in = n_wei = n_far = n_tight = 0
    kinds = set()
    for lay, dp, _ in calls:
        line = dp.line.numpy()
        k_line = dp.k_line.numpy().astype(np.int64)
        frac0 = dp.frac0.numpy()
        tile_of = np.repeat(np.arange(dp.n_tiles),
                            dp.counts.numpy().astype(np.int64) * dp.block)
        s = np.nonzero(line[:tile_of.size] >= 0)[0]
        g, t = line[s], tile_of[s]
        k = t[:, None] * dp.tile + np.arange(dp.tile)[None, :]
        u = (k - k_line[s][:, None]).astype(np.float32) - frac0[s][:, None]
        d = k - k_line[s][:, None]
        for li in lay.numpy():
            w = np.minimum(prm.wing.numpy()[li, g], dp.wcap.numpy()[s])
            wingu = (w.astype(np.float32) / np.float32(dp.dx))[:, None]
            mask = (u > -wingu) & (u <= wingu) & (k < dp.n_out)
            lo, hi = _window_range(frac0[s], wingu[:, 0])
            assert not (mask & ((d < lo[:, None]) | (d > hi[:, None]))).any()
            nlo, nhi, kind, q = _sd_near_range(frac0[s], prm, li, g, dp.dx,
                                               lo, hi)
            kinds |= set(np.unique(kind).tolist())
            near = (d >= nlo[:, None]) & (d <= nhi[:, None])
            w1, w2 = _sd_point_regions(u, dp.dx, *q)
            wei = mask & (w1 | w2)
            assert not (wei & ~near).any(), (label, li)
            closed = (kind > 0)[:, None] & mask
            n_in += int(closed.sum())
            n_wei += int((closed & (w1 | w2)).sum())
            n_far += int((closed & ~near).sum())
            tlo, thi, _, _ = _sd_near_range(frac0[s], prm, li, g, dp.dx, lo,
                                            hi, shrink=0.9)
            n_tight += int((wei & ((d < tlo[:, None])
                                   | (d > thi[:, None]))).sum())
    assert 1 in kinds
    assert n_wei > 0 and n_far > n_in / 2, (n_in, n_wei, n_far)
    assert n_tight > 0


def test_k4_weideman_range_takes_the_window_near_tangency():
    """Pairs in Gamma2's Voigt-limit clamp at low pressure (c up to 3e8):
    there Re X + c^2 lies within 1e-4 of R^2 = (15 + c)^2, the float32
    Im S cancels, and points far outside K5's closed-form radius take
    Weideman; sd_near_range gives such pairs their whole window, so every
    Weideman point of a pair over +-4e6 grid steps lies in its range, and
    the closed form alone would miss some."""
    from types import SimpleNamespace

    g0 = np.repeat(10.0 ** -np.arange(2.0, 9.0), 3)
    g2 = g0 * np.tile([0.0, 1e-5, 0.05], 7)     # clamped, clamped, live
    gd = np.full(g0.size, 1e-3)
    prm = SimpleNamespace(**{k: torch.as_tensor(v[None], dtype=torch.float32)
                             for k, v in (("shift0", 0.0 * g0),
                                          ("gamma_d", gd), ("gamma_0", g0),
                                          ("gamma_2", g2))})
    u = np.unique(np.concatenate([np.arange(-20_000, 20_001),
                                  np.round(np.geomspace(1, 4e6, 20_000)),
                                  -np.round(np.geomspace(1, 4e6, 20_000))]))
    u = u.astype(np.int64)[None, :]
    n = g0.size
    f0 = np.zeros(n, dtype=np.float32)
    lo, hi = np.full(n, -(1 << 30)), np.full(n, 1 << 30)
    nlo, nhi, kind, q = _sd_near_range(f0, prm, 0, np.arange(n), 0.0025,
                                       lo, hi)
    w1, w2 = _sd_point_regions(u.astype(np.float32), 0.0025, *q)
    wei = w1 | w2
    assert not (wei & ((u < nlo[:, None]) | (u > nhi[:, None]))).any()
    assert (kind == 0).any() and (kind == 1).any()
    # K5's radius alone (the closed form for every pair) misses points
    s0, inv_g2, aa, cc = q
    f32 = np.float32
    R2 = (f32(15.0) + cc) ** 2
    P = np.abs(aa)
    r = (np.maximum((R2 - P) * (R2 + P), f32(0.0)) / (f32(2.0) * R2)
         / (inv_g2 * f32(0.0025)))
    clo, chi = _window_range(f0, r * f32(1.0001) + f32(1.0))
    clo = np.where(P >= R2 * f32(1.001), 1, clo)
    chi = np.where(P >= R2 * f32(1.001), 0, chi)
    assert (wei & ((u < clo[:, None]) | (u > chi[:, None]))).any()


@pytest.mark.parametrize("kind", ("one-hot", "dense"))
def test_k4_rows_are_the_live_directions(sd_passes, kind):
    """K4's rows: a (direction, layer) row is live in live_directions
    exactly where one of the direction's (shift0, strength, gamma_d,
    gamma_0, gamma_2) tangents is non-zero on the layer (the one-hot batch:
    one live row a direction), and every pair of a live row with a non-zero
    tangent keeps its in-window indices inside its window range, on both
    builders' sdvoigt passes."""
    from radtxfr_tpu_torch.kernels.fused_xsect import live_directions

    n_in = n_kept = n_pairs = 0
    for calls, prm, tans in sd_passes.values():
        tans = tans[kind]
        nd, n_lay = tans[0].shape[0], tans[0].shape[1]
        live = live_directions(tans, n_lay).numpy()
        nz = np.stack([(t != 0).numpy() for t in tans]).any(axis=0)
        assert (live == nz.any(axis=2)).all()
        if kind == "one-hot":
            assert (live.sum(axis=1) == 1).all()
        for lay, dp, _ in calls:
            for d in range(nd):
                rows = [li for li in lay.numpy() if live[d, li]]
                a, b, c = _check_cull(dp, prm, rows, "asym",
                                      live=lambda li, g: nz[d, li, g])
                n_in, n_kept, n_pairs = n_in + a, n_kept + b, n_pairs + c
    assert n_in > 0 and n_kept - n_in <= 6 * n_pairs


# ---------------------------------------------------------------------------
# ROADMAP queue 3 item 2: the public members the port lacked
# ---------------------------------------------------------------------------

def test_line_store_members_match_jax():
    """``LineStore.n_lines`` and ``select_molecules`` against JAX's on the
    derived list: the same count and the same lines, column for column."""
    from radtxfr_tpu.lines.derived import derived_lwir_linelist as j_derived
    from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist

    j_store = j_derived(700.0, 760.0)
    store = derived_lwir_linelist(700.0, 760.0, device="cpu",
                                  dtype=torch.float64)
    assert store.n_lines == j_store.n_lines == len(store)
    for mols in ((2,), (1, 3), (7,)):
        want = j_store.select_molecules(mols).host_view()
        got = store.select_molecules(mols)
        assert got.n_lines == want.n_lines
        for f in ("nu0", "sw", "elower", "gamma_air", "mol_id", "iso_row"):
            np.testing.assert_array_equal(got.host[f],
                                          np.asarray(getattr(want, f)),
                                          err_msg=f)
        assert got.sw.dtype == torch.float64


def test_tud_squeezed_and_downwelling_angles_match_jax():
    """``TUD.squeezed`` drops the singleton altitude and angle axes as JAX's
    does; ``downwelling_angles`` equals JAX's within 1e-15 (float64)."""
    import jax.numpy as jnp
    from radtxfr_tpu.products import tud as j_tud
    from radtxfr_tpu_torch.products.tud import TUD, downwelling_angles

    rng = np.random.default_rng(5)
    for shape in ((7, 1, 1), (7, 3, 1), (7, 1, 4), (7, 3, 4)):
        tau, Lu = rng.random(shape), rng.random(shape)
        Ld, X = rng.random(7), np.arange(7.0)
        want = j_tud.TUD(X=jnp.asarray(X), tau=jnp.asarray(tau),
                         Lu=jnp.asarray(Lu), Ld=jnp.asarray(Ld)).squeezed()
        got = TUD(X=torch.as_tensor(X), tau=torch.as_tensor(tau),
                  Lu=torch.as_tensor(Lu), Ld=torch.as_tensor(Ld)).squeezed()
        for f in ("tau", "Lu", "Ld"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(want, f)))
    for n in (1, 8, 30):
        got = downwelling_angles(n, device="cpu").numpy()
        want = np.asarray(j_tud.downwelling_angles(n))
        assert got.shape == want.shape == (n,)
        assert np.abs(got - want).max() <= 1e-15


def test_atmospheric_state_replace_matches_jax():
    """``AtmosphericState.replace`` returns a new state with the fields
    given, as JAX's (whose CLI's members are built with it)."""
    from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
    from radtxfr_tpu_torch.atmos.profile import std_atmosphere

    j_atm = j_std_atmosphere()
    atm = std_atmosphere(device="cpu", dtype=torch.float64)
    j_new = j_atm.replace(T=j_atm.T + 5.0, vmr=j_atm.vmr * 2.0)
    new = atm.replace(T=atm.T + 5.0, vmr=atm.vmr * 2.0)
    for f in ("z0", "z1", "pl", "p", "T", "vmr"):
        np.testing.assert_array_equal(getattr(new, f).numpy(),
                                      np.asarray(getattr(j_new, f)))
    assert new.mol_ids == j_new.mol_ids
    np.testing.assert_array_equal(atm.T.numpy(), np.asarray(j_atm.T))


def test_planckian_wavelength_matches_jax():
    """``planckian(..., wavelength=True)`` (µm in, µW/(cm^2 sr µm) out)
    against JAX's within 1e-12 relative, with the wavenumber mode and a
    2-D temperature field."""
    import jax.numpy as jnp
    from radtxfr_tpu.core import planck as j_planck
    from radtxfr_tpu_torch.core.planck import planckian

    lam = np.linspace(7.0, 14.0, 57)
    T = np.random.default_rng(3).uniform(200.0, 320.0, (3, 4))
    for X, wl in ((lam, True), (10000.0 / lam[::-1], False)):
        want = np.asarray(j_planck.planckian(jnp.asarray(X), jnp.asarray(T),
                                             wavelength=wl))
        got = planckian(X, torch.as_tensor(T), wavelength=wl).numpy()
        assert got.shape == want.shape == (X.size, 3, 4)
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_compute_line_params_abundance_ratio_matches_jax(iso_tables):
    """``compute_line_params(..., abundance_ratio=)``, a scalar and a per-line
    ratio, against JAX's within 1e-12 relative (float64); the ratio scales
    the strength only."""
    from radtxfr_tpu.kernels.lineparams import compute_line_params as j_params
    from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic
    from radtxfr_tpu_torch.kernels.lineparams import compute_line_params
    from radtxfr_tpu_torch.lines.store import IsoTables
    from radtxfr_tpu_torch.lines.synthetic import synthetic_lines

    kw = dict(nu_min=600.0, nu_max=700.0, seed=2)
    j_store = j_synthetic(200, **kw)
    store = synthetic_lines(200, **kw, device="cpu", dtype=torch.float64)
    iso = IsoTables.load(device="cpu", dtype=torch.float64)
    ratio = np.random.default_rng(4).uniform(0.5, 2.0, 200)
    for ar in (0.7, ratio):
        want = j_params(j_store, iso_tables, 250.0, 0.5, abundance_ratio=ar)
        got = compute_line_params(store, iso, 250.0, 0.5,
                                  abundance_ratio=ar)
        for f in ("strength", "gamma_d", "gamma_0", "wing", "shift0"):
            a, b = getattr(got, f).numpy(), np.asarray(getattr(want, f))
            assert np.abs(a - b).max() <= 1e-12 * np.abs(b).max(), f
        base = compute_line_params(store, iso, 250.0, 0.5)
        np.testing.assert_allclose(got.strength.numpy(),
                                   base.strength.numpy() * ar, rtol=1e-15)


def test_group_layers_by_wing_alias():
    """``products.od.group_layers_by_wing`` is ``group_by_wing``, as JAX's
    alias, with the same groups."""
    from radtxfr_tpu.products import od as j_od
    from radtxfr_tpu_torch.products import od

    assert od.group_layers_by_wing is od.group_by_wing
    wings = np.random.default_rng(1).lognormal(0.0, 2.0, 40)
    got = od.group_layers_by_wing(wings, max_groups=5, ratio=3.0)
    want = j_od.group_layers_by_wing(wings, max_groups=5, ratio=3.0)
    assert len(got) == len(want)
    for (i, w), (j_i, j_w) in zip(got, want):
        np.testing.assert_array_equal(i, j_i)
        assert w == j_w


# ---------------------------------------------------------------------------
# The single-device modules: TIPS ratio, MT_CKD tables, the resolvent
# oracle, the golden anchors
# ---------------------------------------------------------------------------

def test_partition_sum_ratio_matches_jax():
    """``partition_sum_ratio`` (and ``T_MIN``/``T_MAX``) against JAX's
    within 1e-12 relative over 70-3000 K for every isotopologue row, at
    the default and another reference temperature."""
    import jax.numpy as jnp
    from radtxfr_tpu.lines import tips as j_tips
    from radtxfr_tpu_torch.lines import partition_sum_ratio, tips

    assert (tips.T_MIN, tips.T_MAX) == (j_tips.T_MIN, j_tips.T_MAX)
    q = tips.load_tips_tables()[3]
    rows = np.arange(q.shape[0])[:, None]
    T = np.linspace(tips.T_MIN, tips.T_MAX, 397)[None, :]
    for t_ref in (296.0, 250.0):
        want = np.asarray(j_tips.partition_sum_ratio(
            jnp.asarray(q), jnp.asarray(rows), jnp.asarray(T), t_ref=t_ref))
        got = partition_sum_ratio(torch.as_tensor(q), torch.as_tensor(rows),
                                  torch.as_tensor(T), t_ref=t_ref).numpy()
        assert got.shape == want.shape == (q.shape[0], 397)
        # where a row's table holds zeros (the reference's tables of some
        # isotopologues) the ratio is NaN or infinite in both packages
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0.0)
        assert np.isfinite(got).mean() > 0.9


@pytest.fixture
def h2o_tables_restored():
    """Both packages' installed H2O continuum tables, put back after the
    test."""
    from radtxfr_tpu.atmos import continuum as j_cont
    from radtxfr_tpu_torch.atmos import continuum as cont

    before = (j_cont._ACTIVE_H2O_TABLES, cont._ACTIVE_H2O_TABLES)
    yield j_cont, cont
    j_cont.set_h2o_tables(before[0])
    cont.set_h2o_tables(before[1])


def _mt_ckd_file(path, names):
    """An AER-style MT_CKD coefficient file: smooth coefficients over
    400-7100 cm^-1 under the dataset ``names``."""
    import h5py

    nu = np.linspace(400.0, 7100.0, 1341)
    base = 1e-26 * np.exp(-(nu - 400.0) / 900.0) + 1e-29
    with h5py.File(path, "w") as f:
        f[names[0]] = nu
        f[names[1]] = 3.0 * base
        f[names[2]] = 5.0 * base
        f[names[3]] = 0.2 * base
        f["ref_temp"] = np.array([296.0])


def test_mt_ckd_tables_and_set_h2o_tables_match_jax(tmp_path,
                                                    h2o_tables_restored):
    """``load_mt_ckd_tables`` on a file the test writes gives JAX's arrays
    (exact dataset names, and the fuzzy binding with its warning); after
    ``set_h2o_tables`` in both packages the ``mt_ckd`` continuum, pointwise
    (``continuum_od``) and layered (``make_layered_mt_ckd``, its default
    ``tables`` read at call time), agrees with JAX's within 1e-12 relative
    and differs from the packaged tables' in both packages."""
    import jax.numpy as jnp
    from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
    from radtxfr_tpu_torch.atmos.profile import std_atmosphere

    j_cont, cont = h2o_tables_restored
    exact = str(tmp_path / "exact.nc")
    _mt_ckd_file(exact, ("wavenumbers", "self_absco_ref", "self_absco_260",
                         "for_absco_ref"))
    fuzzy = str(tmp_path / "fuzzy.nc")
    _mt_ckd_file(fuzzy, ("Wavenumber_grid", "Self_Ref_296", "self_at_260K",
                         "for_absco_296"))
    for path in (exact, fuzzy):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            got = cont.load_mt_ckd_tables(path)
            want = j_cont.load_mt_ckd_tables(path)
        # four bindings each, the port's and JAX's
        assert sum("fuzzily bound" in str(w.message) for w in caught) \
            == (8 if path == fuzzy else 0)
        for f in ("nu", "cs296", "cs260", "cf"):
            np.testing.assert_array_equal(getattr(got, f),
                                          getattr(want, f))
    bad = str(tmp_path / "bad.nc")
    _mt_ckd_file(bad, ("a", "b", "c", "d"))
    with pytest.raises(KeyError):
        cont.load_mt_ckd_tables(bad)

    nu = np.linspace(700.0, 1300.0, 301)
    atm = std_atmosphere(device="cpu", dtype=torch.float64)
    j_atm = j_std_atmosphere()
    cf = torch.ones(7, dtype=torch.float64)

    def port():
        layered = cont.make_layered_mt_ckd(nu, atm.mol_ids, device="cpu",
                                           dtype=torch.float64)
        return (cont.continuum_od(torch.as_tensor(nu), atm, "mt_ckd").numpy(),
                layered(atm.T, atm.p, atm.pl, atm.vmr, cf).numpy())

    def jax():
        layered = j_cont.make_layered_mt_ckd(nu, j_atm.mol_ids)
        return (np.asarray(j_cont.continuum_od(jnp.asarray(nu), j_atm,
                                               "mt_ckd")),
                np.asarray(layered(j_atm.T, j_atm.p, j_atm.pl, j_atm.vmr,
                                   jnp.ones(7))))

    packaged = port()
    j_cont.set_h2o_tables(j_cont.load_mt_ckd_tables(exact))
    cont.set_h2o_tables(cont.load_mt_ckd_tables(exact))
    assert cont._ACTIVE_H2O_TABLES is not cont.H2O_CONTINUUM_LWIR
    installed, j_installed = port(), jax()
    for got, want, before in zip(installed, j_installed, packaged):
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()
        assert np.abs(got - before).max() > 1e-3 * np.abs(before).max()
    # an explicit table still wins over the installed one
    explicit = cont.make_layered_mt_ckd(
        nu, atm.mol_ids, device="cpu", dtype=torch.float64,
        tables=cont.H2O_CONTINUUM_LWIR)(atm.T, atm.p, atm.pl, atm.vmr, cf)
    np.testing.assert_array_equal(explicit.numpy(), packaged[1])
    # the coverage check reads the installed table too
    cont.set_h2o_tables(cont.H2OContinuumTables(
        nu=[800.0, 900.0], cs296=[1e-22, 1e-22], cs260=[2e-22, 2e-22],
        cf=[1e-24, 1e-24]))
    with pytest.warns(UserWarning, match="covers 800-900"):
        cont.check_h2o_table_coverage(700.0, 1000.0)


def test_branch_profile_full_w_matches_jax():
    """The exact resolvent oracle on a derived CO2 Q branch equals JAX's
    (both float64 NumPy on the host)."""
    from radtxfr_tpu.kernels import linemixing_data as j_lm
    from radtxfr_tpu_torch.kernels import linemixing_data as lm
    from radtxfr_tpu_torch.lines.derived import co2_lwir_lines

    rows = co2_lwir_lines()
    m = (rows["band"] == rows["band"][0]) & (rows["dJ"] == 0)
    k = np.nonzero(m)[0][:12]
    args = [rows[c][k] for c in ("nu0", "sw", "gamma_air", "elower")]
    grid = np.linspace(args[0].min() - 1.0, args[0].max() + 1.0, 120)
    for p_atm in (0.5, 1.0):
        got = lm.branch_profile_full_w(grid, *args, 260.0, p_atm)
        want = j_lm.branch_profile_full_w(grid, *args, 260.0, p_atm)
        np.testing.assert_array_equal(got, want)
        assert np.abs(got).max() > 0.0
    assert "branch_profile_full_w" in lm.__all__


def test_golden_anchors_match_jax():
    """``co2_laser_golden``, ``match_golden_positions`` and
    ``band_intensity_residuals`` equal JAX's, on the port's derived list."""
    from radtxfr_tpu.lines import golden as j_golden
    from radtxfr_tpu_torch.lines import golden

    for got, want in zip(golden.co2_laser_golden(),
                         j_golden.co2_laser_golden()):
        np.testing.assert_array_equal(got, want)
    got, want = golden.match_golden_positions(), \
        j_golden.match_golden_positions()
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[2] == want[2] and np.isfinite(got[1]).all()
    assert golden.LITERATURE_BAND_INTENSITIES == \
        j_golden.LITERATURE_BAND_INTENSITIES
    assert golden.band_intensity_residuals() == \
        j_golden.band_intensity_residuals()
