"""The port's CUDA kernels on a card (marker ``cuda``; skipped where
``torch.cuda.is_available()`` is false).

This file imports no JAX, so it also runs on a machine with a card and no
JAX: ``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``.
"""

from collections import Counter

import pytest
import torch

from radtxfr_tpu_torch.atmos.profile import std_atmosphere
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.kernels import fused_tud, fused_xsect
from radtxfr_tpu_torch.kernels.linemixing_data import y_air_for_store
from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist
from radtxfr_tpu_torch.lines.store import IsoTables
from radtxfr_tpu_torch.products.od import make_od_fn
from radtxfr_tpu_torch.products.tud import (_layers_below,
                                            downwelling_quadrature,
                                            make_tud_fn)
from radtxfr_tpu_torch.sensor.resolution import reduce_operator
from radtxfr_tpu_torch.tools import fp32_peak

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    return torch.device("cuda")


def _od_fn(dev, fast_rcp=True):
    f32 = torch.float32
    store = derived_lwir_linelist(695.0, 745.0, device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    od_fn = make_od_fn(store, IsoTables.load(device=dev, dtype=f32),
                       arange_drift_free(716.0, 726.0, 0.0005), base,
                       line_mixing={"y_air": y_air_for_store(
                           store.host_view())}, fast_rcp=fast_rcp)
    return od_fn, base


def _tud_args(dev, od, x, base):
    f32 = torch.float32
    sec, w = (torch.as_tensor(a, dtype=f32, device=dev)
              for a in downwelling_quadrature(30))
    snap = torch.as_tensor(_layers_below(base.z0.cpu().numpy(), [1.0, 500.0]),
                           dtype=torch.int32, device=dev)
    return [od, x, (1.0 / base.T).contiguous(),
            torch.ones(1, dtype=f32, device=dev), snap, sec, w]


@pytest.mark.parametrize("fast_rcp", (True, False))
def test_fused_xsect_kernel_matches_plain(dev, fast_rcp):
    """The production OD builder's passes (asym, core, mix) in the
    instantiation ``fast_rcp`` picks (True: the FAST one, the builders'
    default) against their plain versions, each launch counted under its
    own key; with fast_rcp=True, the largest difference from the IEEE
    instantiation is printed as a share of the line-OD peak."""
    od_fn, base = _od_fn(dev, fast_rcp)
    prm, Y = od_fn.line_params(base.T, base.p, base.pl, base.vmr)
    line_od = torch.zeros((base.n_layers, od_fn.n_x), device=dev)
    pairs = []
    for call in od_fn.calls:
        key = fused_xsect.launch_key(call[2], fast_rcp)
        other = fused_xsect.launch_key(call[2], not fast_rcp)
        before = Counter(fused_xsect.LAUNCHES)
        got = od_fn.run_call(call, prm, Y)
        torch.cuda.synchronize()
        assert fused_xsect.LAUNCHES[key] == before[key] + 1, key
        assert fused_xsect.LAUNCHES[other] == before[other], other
        assert torch.equal(got, od_fn.run_call(call, prm, Y))  # no atomics
        want = od_fn.run_call(call, prm, Y,
                              kernel=fused_xsect.xsect_fused_plain)
        line_od[call[0].long()] += want
        pairs.append((call, got, want))
    for (lay, dplan, mode), got, want in pairs:
        peak = line_od[lay.long()].abs().max()
        err = (got - want).abs().max()
        if fast_rcp:
            od_fn.fast_rcp = False
            ieee = od_fn.run_call((lay, dplan, mode), prm, Y)
            od_fn.fast_rcp = True
            print(f"[fast_rcp] K1 {mode}: FAST vs plain "
                  f"{float(err / peak):.3e}, FAST vs IEEE "
                  f"{float((got - ieee).abs().max() / peak):.3e} of the "
                  "line-OD peak")
        # <= 2e-6 of the line-OD peak of the pass's layers (chip_smoke.py)
        assert err <= 2e-6 * peak
        # and of the pass's own peak: 2e-6 (asym, mix), 5e-2 (core, a
        # difference of near-equal float32 shapes; chip_smoke.K1_OWN_BOUND)
        own = want.abs().max()
        assert own > 0.0
        assert err <= (5e-2 if mode == "core" else 2e-6) * own


def test_fused_tud_kernel_matches_plain(dev):
    base = std_atmosphere(device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(1)
    od = 0.2 * torch.rand((base.n_layers, 5000), generator=gen, device=dev)
    x = torch.linspace(690.0, 1410.0, 5000, device=dev)
    args = _tud_args(dev, od, x, base)
    got = fused_tud.tud_compose(*args)
    want = fused_tud.tud_compose_plain(*args)
    for g, r in zip(got, want):
        assert (g - r).abs().max() <= 5e-6 * r.abs().max()   # of peak


@pytest.mark.parametrize("n_x,n_angles,mu", [(5000, 30, [1.0]),
                                             (777, 40, [1.0, 1.6])])
def test_fused_tud_source_input_matches_plain(dev, n_x, n_angles, mu):
    """planck=False: B (nL, nX) an input, read by the kernel (two angle
    chunks and two secants in the second case)."""
    base = std_atmosphere(device=dev, dtype=torch.float32)
    gen = torch.Generator(device=dev).manual_seed(2)
    od = 0.2 * torch.rand((base.n_layers, n_x), generator=gen, device=dev)
    B = torch.rand((base.n_layers, n_x), generator=gen, device=dev) + 0.5
    args = _tud_args(dev, od, None, base)
    args[1:3] = [None, None]
    args[3] = torch.tensor(mu, device=dev)
    args[5:7] = [torch.as_tensor(a, dtype=torch.float32, device=dev)
                 for a in downwelling_quadrature(n_angles)]
    before = fused_tud.LAUNCHES["tud_b"]
    got = fused_tud.tud_compose(*args, B=B)
    assert fused_tud.LAUNCHES["tud_b"] == before + 1
    want = fused_tud.tud_compose_plain(*args, B=B)
    for g, r in zip(got, want):
        assert (g - r).abs().max() <= 5e-6 * r.abs().max()   # of peak
    # make_tud_fn(planck=False) takes fn(x, od, B)
    z0 = base.z0.cpu().numpy()
    tud = make_tud_fn(z0, [1.0, 500.0], mu=mu, n_angles=n_angles,
                      planck=False)(torch.arange(n_x, device=dev), od, B)
    assert torch.equal(tud.tau, got[0]) and torch.equal(tud.Ld, got[2])


def test_fused_tud_raises_before_launch_outside_its_limits(dev):
    """65 altitudes, or more altitude-secant rows than a CTA's shared
    memory holds, raise ValueError and launch nothing."""
    base = std_atmosphere(device=dev, dtype=torch.float32)
    od = torch.rand((base.n_layers, 300), device=dev)
    args = _tud_args(dev, od, torch.linspace(690.0, 1410.0, 300, device=dev),
                     base)
    before = dict(fused_tud.LAUNCHES)
    many = torch.zeros(fused_tud.MAX_ALTITUDES + 1, dtype=torch.int32,
                       device=dev)
    with pytest.raises(ValueError, match="at most 64 sensor altitudes"):
        fused_tud.tud_compose(*args[:4], many, *args[5:])
    with pytest.raises(ValueError, match="shared memory"):
        fused_tud.tud_compose(*args[:3], torch.ones(7, device=dev),
                              many[:60], *args[5:])
    assert fused_tud.LAUNCHES == before


#: the TUD Jacobian cell's altitudes (benchmark/configs/lwir_tud_prod.json)
JAC_ALTITUDES = [0.061, 0.305, 1.524, 3.048, 6.096, 9.144, 12.192, 15.24,
                 500.0]


def _jvp_args(dev, n_x, n_dirs, seed, alts=JAC_ALTITUDES, mu=(1.0,),
              n_angles=30):
    """K2's Planck-mode arguments on the standard atmosphere (log-uniform
    OD, 1e-4 to 10) at ``alts`` (the cell's altitudes), and ``n_dirs``
    dense directions (OD tangents a twentieth of the OD, T tangents of
    1 K)."""
    f32 = torch.float32
    base = std_atmosphere(device=dev, dtype=f32)
    gen = torch.Generator(device=dev).manual_seed(seed)
    od = 10.0 ** (5.0 * torch.rand((base.n_layers, n_x), generator=gen,
                                   device=dev) - 4.0)
    x = torch.linspace(690.0, 1410.0, n_x, device=dev)
    args = _tud_args(dev, od, x, base)
    args[3] = torch.tensor(mu, dtype=f32, device=dev)
    args[4] = torch.as_tensor(_layers_below(base.z0.cpu().numpy(), alts),
                              dtype=torch.int32, device=dev)
    args[5:7] = (torch.as_tensor(a, dtype=f32, device=dev)
                 for a in downwelling_quadrature(n_angles))
    dod = 0.05 * od * torch.randn((n_dirs,) + tuple(od.shape),
                                  generator=gen, device=dev)
    dT = torch.randn((n_dirs, base.n_layers), generator=gen, device=dev)
    return args, base, dod, dT


def _tangents_match_plain(args, dod, dT):
    """One launch of K2's tangent mode against its plain version: each
    direction's tangents within 1e-5 of their own peak, reruns
    bit-identical."""
    n_d = dod.shape[0]
    before = fused_tud.LAUNCHES["tud_jvp"]
    got = fused_tud.tud_compose_jvp(*args, dod, dT)
    assert fused_tud.LAUNCHES["tud_jvp"] == before + 1
    assert all(torch.equal(a, b) for a, b in
               zip(got, fused_tud.tud_compose_jvp(*args, dod, dT)))
    want = fused_tud.tud_compose_jvp_plain(*args, dod, dT)
    for g, r in zip(got, want):
        assert g.shape == r.shape and g.shape[0] == n_d
        for d in range(n_d):
            assert r[d].abs().max() > 0
            assert (g[d] - r[d]).abs().max() <= 1e-5 * r[d].abs().max()


def test_fused_tud_jvp_kernel_matches_plain(dev):
    """K2's tangent mode at the Jacobian cell's shape (66 layers, 1,440,001
    points, 9 altitudes, 1 secant, 30 angles, 8 directions) in one launch
    against its plain version: each direction's tangents within 1e-5 of
    their own peak, reruns bit-identical; the primal, K2's, within its
    5e-6 of the plain composition."""
    n_x = arange_drift_free(690.0, 1410.0, 0.0005).size
    args, _, dod, dT = _jvp_args(dev, n_x, 8, seed=3)
    _tangents_match_plain(args, dod, dT)
    for g, r in zip(fused_tud.tud_compose(*args),
                    fused_tud.tud_compose_plain(*args)):
        assert (g - r).abs().max() <= 5e-6 * r.abs().max()   # of peak


def test_fused_tud_jvp_kernel_chunks_match_plain(dev):
    """K2's tangent mode beyond one chunk of each kind: 11 directions (two
    chunks of 8, the second short), 40 angles (two chunks of 32, S_B apart
    from the prefix OD), 2 secants and an altitude below the ground layer,
    on 5,001 points (a short last CTA), against its plain version within
    1e-5 of each direction's peak."""
    args, _, dod, dT = _jvp_args(dev, 5001, 11, seed=5,
                                 alts=[-1.0, 0.061, 3.048, 500.0],
                                 mu=(1.0, 1.7), n_angles=40)
    _tangents_match_plain(args, dod, dT)


def test_fused_tud_diff_launches_once_a_batch(dev):
    """``tud_compose_diff`` under ``vmap(jvp)``: K2 once for the value and
    the tangent mode once for the whole batch of directions, its tangents
    those of a direct launch; a direction's missing T tangent is zero."""
    args, base, dod, dT = _jvp_args(dev, 3001, 5, seed=4)
    od, x, _, *geom = args
    T = base.T

    def f(o, t):
        return fused_tud.tud_compose_diff(o, x, t, *geom)

    before = dict(fused_tud.LAUNCHES)
    value, tan = torch.func.vmap(lambda a, b: torch.func.jvp(
        f, (od, T), (a, b)))(dod, dT)
    assert fused_tud.LAUNCHES["tud_jvp"] == before["tud_jvp"] + 1
    assert fused_tud.LAUNCHES["tud"] == before["tud"] + 1
    want = fused_tud.tud_compose_jvp(*args, dod, dT)
    for g, r in zip(tan, want):
        assert torch.equal(g, r)
    for g, r in zip(value, fused_tud.tud_compose(*args)):
        assert torch.equal(g[0], r)      # vmap's out_dims spread the value
    _, od_only = torch.func.jvp(lambda o: f(o, T), (od,), (dod[0],))
    zero_t = fused_tud.tud_compose_jvp(*args, dod[:1],
                                       torch.zeros_like(dT[:1]))
    for g, r in zip(od_only, zero_t):
        assert torch.equal(g, r[0])


def test_tud_jacobian_k2_matches_plain_composition(dev, monkeypatch):
    """``make_tud_jacobian_fn`` on a (1 x 1) mesh in float32: with K2 and
    its tangent mode (the default on the card) against its own plain
    composition (``planckian`` and ``tud_from_od``), 8 one-hot T, H2O and
    O3 directions: the primal and each direction's tangents within the
    Jacobian cell's limits (tau 5e-4 absolute; Lu, Ld and every tangent
    1e-3 of its peak)."""
    from radtxfr_tpu_torch.products import tud
    from radtxfr_tpu_torch.dist.fused_ensemble import (jacobian_directions,
                                                       make_tud_jacobian_fn)
    from radtxfr_tpu_torch.dist.mesh import make_mesh

    f32 = torch.float32
    store = derived_lwir_linelist(695.0, 745.0, device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    iso = IsoTables.load(device=dev, dtype=f32)
    X = arange_drift_free(716.0, 726.0, 0.0005)
    V_T, V_vmr, _ = jacobian_directions(base)
    pick = [0, 30, 65, 66 + 5, 66 + 40, 132 + 10, 132 + 50, 20]
    outs, launches = [], []
    for k2 in (True, False):
        monkeypatch.setattr(tud, "_k2_composes",
                            lambda od, k2=k2: k2)
        _, run = make_tud_jacobian_fn(store, iso, X, base, JAC_ALTITUDES,
                                      make_mesh(1, 1, devices=[dev]),
                                      continuum="mt_ckd")
        before = fused_tud.LAUNCHES["tud_jvp"]
        outs.append(run(base.T, base.vmr, V_T[pick], V_vmr[pick]))
        launches.append(fused_tud.LAUNCHES["tud_jvp"] - before)
    assert launches == [1, 0]
    (p1, t1), (p0, t0) = outs
    assert (p1["tau"] - p0["tau"]).abs().max() <= 5e-4
    for k in ("Lu", "Ld"):
        assert (p1[k] - p0[k]).abs().max() <= 1e-3 * p0[k].abs().max()
    for k in ("tau", "Lu", "Ld"):
        for j in range(len(pick)):
            assert (t1[k][j] - t0[k][j]).abs().max() <= \
                1e-3 * t0[k][j].abs().max(), (k, j)


def test_wrappers_raise_on_float64_and_non_contiguous(dev):
    od_fn, base = _od_fn(dev)
    prm, Y = od_fn.line_params(base.T, base.p, base.pl, base.vmr)
    lay, dplan, mode = od_fn.calls[0]
    p = [prm.shift0, prm.strength, prm.gamma_d, prm.gamma_0, prm.wing]
    with pytest.raises(TypeError, match="float32"):
        fused_xsect.xsect_fused(dplan, lay, *[a.double() for a in p], Y,
                                mode)
    with pytest.raises(ValueError, match="contiguous"):
        strided = [a.t().contiguous().t() for a in p]
        fused_xsect.xsect_fused(dplan, lay, *strided, Y, mode)

    x = torch.linspace(690.0, 1410.0, 300, device=dev)
    od = torch.rand((base.n_layers, 300), device=dev)
    args = _tud_args(dev, od, x, base)
    with pytest.raises(TypeError, match="float32"):
        fused_tud.tud_compose(od.double(), *args[1:])
    with pytest.raises(ValueError, match="contiguous"):
        fused_tud.tud_compose(od.t().contiguous().t(), *args[1:])


def test_full_and_tangent_kernels_match_plain(dev):
    """K1 'full' and K3 against their plain versions on every pass of the
    differentiable builder: the primal within 2e-6 of its peak, each
    direction's tangent within 2e-5 of its own peak (chip_smoke.py), for a
    T direction over all layers and 8 one-hot T directions (9 directions:
    two K3 launches); two launches bit-identical."""
    f32 = torch.float32
    store = derived_lwir_linelist(695.0, 745.0, device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    od_fn = make_od_fn(store, IsoTables.load(device=dev, dtype=f32),
                       arange_drift_free(716.0, 726.0, 0.0005), base,
                       continuum="mt_ckd", differentiable=True)
    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr
    prm = od_fn.line_params(T, p, pl, vmr)[0]

    def prm_of(T_):
        q = od_fn.line_params(T_, p, pl, vmr)[0]
        return q.shift0, q.strength, q.gamma_d, q.gamma_0

    V = torch.cat([torch.linspace(0.5, 1.5, base.n_layers, device=dev)[None],
                   torch.eye(base.n_layers, device=dev)[24:32]])
    tans = [t.contiguous() for t in torch.func.vmap(
        lambda v: torch.func.jvp(prm_of, (T,), (v,))[1])(V)]
    jvp0 = fused_xsect.LAUNCHES["jvp"]
    for lay, dplan, mode in od_fn.calls:
        assert mode == "full"
        args = (dplan, lay, prm.shift0, prm.strength, prm.gamma_d,
                prm.gamma_0, prm.wing)
        got = fused_xsect.xsect_fused(*args, None, "full")
        assert torch.equal(got, fused_xsect.xsect_fused(*args, None, "full"))
        want = fused_xsect.xsect_fused_plain(*args, None, "full")
        assert (got - want).abs().max() <= 2e-6 * want.abs().max()
        tan = fused_xsect.xsect_fused_jvp(*args, *tans)
        assert tan.shape == (9, lay.numel(), od_fn.n_x)
        assert torch.equal(tan, fused_xsect.xsect_fused_jvp(*args, *tans))
        want_t = fused_xsect.xsect_fused_jvp_plain(*args, *tans)
        for d in range(9):
            own = want_t[d].abs().max()
            err = (tan[d] - want_t[d]).abs().max()
            assert err <= 2e-5 * own if own > 0 else err == 0
    assert fused_xsect.LAUNCHES["jvp"] - jvp0 == 4 * len(od_fn.calls)


#: K1's modes of the XS lattice, checked against their plain versions on
#: random parameters within 2e-6 of the pass's own peak (the SD-Voigt
#: block, whose w(Z1) - w(Z2) difference amplifies float32 rounding, follows
#: the plain version's operations uncontracted)
NEW_MODES = ("lorentz", "doppler", "sdvoigt", "sdvoigt_asym", "sdvoigt_core",
             "corr:64:voigt", "corr:64:voigtfull", "corr:64:sdvoigt",
             "corr:64:sdvoigtfull", "corr:16:sdvoigt")


def _random_case(dev, n_lines=600, n_lay=7, n_pts=40000, tile=512):
    """Lines over 995-1105 cm^-1 on a 0.0025 grid, random (nLay, L)
    parameters of the lattice's ranges, per-line wings 2-12 cm^-1."""
    import numpy as np

    rng = np.random.default_rng(7)
    g = fused_xsect.UniformGrid(x0=1000.0, dx=0.0025, n=n_pts)
    nu0 = np.sort(rng.uniform(995.0, 1105.0, n_lines))
    wings = rng.uniform(2.0, 12.0, n_lines)
    plan = fused_xsect.plan_buckets_packed(nu0, g, wings, tile=tile,
                                           block=32)
    dp = fused_xsect.device_plan(plan, np.arange(n_lines), nu0, device=dev)
    mk = lambda lo, hi: torch.as_tensor(  # noqa: E731
        rng.uniform(lo, hi, (n_lay, n_lines)), dtype=torch.float32,
        device=dev)
    prm = dict(shift0=mk(-0.01, 0.01), strength=mk(0.5, 2.0),
               gamma_d=mk(0.0005, 0.002), gamma_0=mk(0.002, 0.1),
               wing=torch.as_tensor(np.tile(wings, (n_lay, 1)),
                                    dtype=torch.float32, device=dev))
    prm["gamma_2"] = prm["gamma_0"] * mk(0.05, 0.15)    # sd_air ratios
    return dp, torch.arange(n_lay, dtype=torch.int32, device=dev), prm


@pytest.mark.parametrize("mode", NEW_MODES)
def test_xs_lattice_modes_match_plain(dev, mode):
    """Each mode the XS lattice adds against its plain version (a tile of
    512 so that the correction passes' R = 16 and 64 both divide it)."""
    dp, lay, prm = _random_case(dev)
    g2 = prm.pop("gamma_2")
    n0 = fused_xsect.LAUNCHES[mode]
    got = fused_xsect.xsect_fused(dp, lay, *prm.values(), None, mode,
                                  gamma_2=g2)
    torch.cuda.synchronize()
    assert fused_xsect.LAUNCHES[mode] == n0 + 1
    want = fused_xsect.xsect_fused_plain(dp, lay, *prm.values(), None, mode,
                                         gamma_2=g2)
    own = want.abs().max()
    assert own > 0.0 and bool(torch.isfinite(got).all())
    assert (got - want).abs().max() <= 2e-6 * own, \
        float((got - want).abs().max() / own)


def test_corr_pass_reruns_bit_identical_and_checks_R(dev):
    """A correction pass gives bit-identical reruns (no atomics); an R that
    does not divide the kernel's 256-point slice raises before any launch."""
    dp, lay, prm = _random_case(dev)
    g2 = prm.pop("gamma_2")
    run = lambda m: fused_xsect.xsect_fused(  # noqa: E731
        dp, lay, *prm.values(), None, m, gamma_2=g2)
    assert torch.equal(run("corr:64:sdvoigt"), run("corr:64:sdvoigt"))
    for bad in ("corr:48:voigt", "corr:4:voigt", "corr:512:voigt"):
        with pytest.raises(ValueError, match="divides"):
            run(bad)


def _sd_tangents(dev, prm, nd, seed=3):
    """(nd, nLay, L) random tangents of (shift0, strength, gamma_d, gamma_0,
    gamma_2), each scaled like its parameter."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    return [(torch.randn((nd,) + tuple(prm[k].shape), generator=gen,
                         device=dev) * prm[k].abs().mean()).contiguous()
            for k in ("shift0", "strength", "gamma_d", "gamma_0", "gamma_2")]


def test_sdvoigt_tangent_kernel_matches_plain(dev):
    """K4 against its plain version on random SD-Voigt parameters (3
    directions, one launch): each direction within 2e-5 of its own peak
    (K3's card bound above); two launches bit-identical; a float64 or
    wrongly shaped tangent raises."""
    dp, lay, prm = _random_case(dev, n_pts=20000)
    args = (dp, lay, prm["shift0"], prm["strength"], prm["gamma_d"],
            prm["gamma_0"], prm["gamma_2"], prm["wing"])
    tans = _sd_tangents(dev, prm, 3)
    n0 = fused_xsect.LAUNCHES["sdvoigt_jvp"]
    got = fused_xsect.xsect_sdvoigt_jvp(*args, *tans)
    assert fused_xsect.LAUNCHES["sdvoigt_jvp"] == n0 + 1
    assert torch.equal(got, fused_xsect.xsect_sdvoigt_jvp(*args, *tans))
    want = fused_xsect.xsect_sdvoigt_jvp_plain(*args, *tans)
    for d in range(3):
        own = want[d].abs().max()
        assert own > 0.0
        assert (got[d] - want[d]).abs().max() <= 2e-5 * own, \
            float((got[d] - want[d]).abs().max() / own)
    with pytest.raises(TypeError, match="float32"):
        fused_xsect.xsect_sdvoigt_jvp(*args, *[t.double() for t in tans])
    with pytest.raises(ValueError, match="shape"):
        fused_xsect.xsect_sdvoigt_jvp(*args, *[t[:, :-1].contiguous()
                                               for t in tans])


def _ht_case(dev, n_lines=300, n_lay=5, n_pts=20000):
    """Lines over 995-1055 cm^-1 on a 0.0025 grid, tile 128 (the HT
    builders'), random per-(layer, line) HT parameters: a third of the
    lines Voigt-like (Gamma2 = Shift2 = 0: pcqsdhc's PART1), the rest with
    live Gamma2, Shift2, nuVC and a complex eta; wings 1-5 cm^-1."""
    import numpy as np

    from radtxfr_tpu_torch.kernels.htp_real import ht_line_constants

    rng = np.random.default_rng(11)
    g = fused_xsect.UniformGrid(x0=1000.0, dx=0.0025, n=n_pts)
    nu0 = np.sort(rng.uniform(995.0, 1055.0, n_lines))
    wings = rng.uniform(1.0, 5.0, n_lines)
    plan = fused_xsect.plan_buckets_packed(nu0, g, wings, tile=128, block=32)
    dp = fused_xsect.device_plan(plan, np.arange(n_lines), nu0, device=dev)
    live = rng.random(n_lines) > 1.0 / 3.0
    mk = lambda lo, hi, m=None: torch.as_tensor(  # noqa: E731
        rng.uniform(lo, hi, (n_lay, n_lines)) * (1.0 if m is None else m),
        dtype=torch.float32, device=dev)
    g0 = mk(0.002, 0.1)
    k = ht_line_constants(mk(0.0005, 0.002), g0, g0 * mk(0.05, 0.15, live),
                          mk(-0.01, 0.01), mk(-5e-4, 5e-4, live),
                          mk(0.0, 0.05, live), mk(0.0, 0.3, live),
                          mk(-0.05, 0.05, live))
    from radtxfr_tpu_torch.kernels.htp_real import HT_CONST_KEYS
    consts = [k[key].contiguous() for key in HT_CONST_KEYS]
    strength = mk(0.5, 2.0)
    wing = torch.as_tensor(np.tile(wings, (n_lay, 1)), dtype=torch.float32,
                           device=dev)
    return dp, torch.arange(n_lay, dtype=torch.int32, device=dev), strength, \
        wing, consts


def test_ht_kernel_matches_plain(dev):
    """K5 against its plain version: within 2e-6 of the pass's peak (the
    kernel follows the plain version's operations uncontracted); two
    launches bit-identical; a float64, non-contiguous or wrongly counted
    constant set raises."""
    from radtxfr_tpu_torch.kernels import fused_ht

    dp, lay, s, w, consts = _ht_case(dev)
    n0 = fused_xsect.LAUNCHES["ht"]
    got = fused_ht.xsect_ht(dp, lay, s, w, consts)
    assert fused_xsect.LAUNCHES["ht"] == n0 + 1
    assert torch.equal(got, fused_ht.xsect_ht(dp, lay, s, w, consts))
    want = fused_ht.xsect_ht_plain(dp, lay, s, w, consts)
    own = want.abs().max()
    assert own > 0.0 and bool(torch.isfinite(got).all())
    assert (got - want).abs().max() <= 2e-6 * own, \
        float((got - want).abs().max() / own)
    with pytest.raises(TypeError, match="float32"):
        fused_ht.xsect_ht(dp, lay, s.double(), w, consts)
    with pytest.raises(ValueError, match="contiguous"):
        fused_ht.xsect_ht(dp, lay, s, w, [c.t().contiguous().t()
                                          for c in consts])
    with pytest.raises(ValueError, match="HT constants"):
        fused_ht.xsect_ht(dp, lay, s, w, consts[:-1])


def test_ht_tangent_kernel_matches_plain(dev):
    """K6 against its plain version (``torch.func.jvp`` through
    pcqsdhc_real, non-finite tangents zeroed) for 3 random directions: each
    within 2e-6 of its own peak (K5's bound: the dual numbers use torch's
    derivative formulas, each operation rounded on its own, so K6 rounds as
    the plain version does); two launches bit-identical; a batch of
    directions under ``vmap`` of ``jvp`` of :func:`xsect_ht_diff` runs K6
    once per ``HT_JVP_DIRS`` directions, not once per direction."""
    from radtxfr_tpu_torch.kernels import fused_ht

    dp, lay, s, w, consts = _ht_case(dev, n_pts=8000)
    gen = torch.Generator(device=dev).manual_seed(5)
    rnd = lambda a, nd: (torch.randn((nd,) + tuple(a.shape),  # noqa: E731
                                     generator=gen, device=dev)
                         * a.abs().mean()).contiguous()
    s_t = rnd(s, 3)
    c_t = [rnd(c, 3) for c in consts]
    got = fused_ht.xsect_ht_jvp(dp, lay, s, w, consts, s_t, c_t)
    assert torch.equal(got, fused_ht.xsect_ht_jvp(dp, lay, s, w, consts,
                                                  s_t, c_t))
    want = fused_ht.xsect_ht_jvp_plain(dp, lay, s, w, consts, s_t, c_t)
    for d in range(3):
        own = want[d].abs().max()
        assert own > 0.0 and bool(torch.isfinite(got[d]).all())
        assert (got[d] - want[d]).abs().max() <= 2e-6 * own, \
            float((got[d] - want[d]).abs().max() / own)

    n_dir = 2 * fused_ht.HT_JVP_DIRS
    n0 = fused_xsect.LAUNCHES["ht_jvp"]
    _, tan = torch.func.vmap(lambda v: torch.func.jvp(
        lambda x: fused_ht.xsect_ht_diff(dp, lay, x, w, consts), (s,),
        (v,)), out_dims=(None, 0))(rnd(s, n_dir))
    assert tan.shape == (n_dir, lay.numel(), dp.n_out)
    assert fused_xsect.LAUNCHES["ht_jvp"] == n0 + 2


def test_defaults_run_on_the_card():
    """With no device and no dtype argument, the constructors and builders
    run on the card, in float32, through the kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is "
                    "false)")
    before = Counter(fused_xsect.LAUNCHES, tud=fused_tud.LAUNCHES["tud"])
    X = arange_drift_free(716.0, 726.0, 0.0005)
    base = std_atmosphere()
    od_fn = make_od_fn(derived_lwir_linelist(691.0, 751.0),
                       IsoTables.load(), X, base, continuum="mt_ckd")
    od = od_fn(base.T, base.p, base.pl, base.vmr)
    assert od.is_cuda and od.dtype == torch.float32
    tud = make_tud_fn(base.z0.cpu().numpy(), [1.0, 500.0])(X, od, base.T)
    ld = reduce_operator(X, 0.25)(tud.Ld)
    assert ld.is_cuda and bool(torch.isfinite(ld).all())
    # the builders' default is JAX's fast_rcp=True: the FAST instantiations
    for k in ("asym", "core"):
        fk = fused_xsect.launch_key(k, True)
        assert fused_xsect.LAUNCHES[fk] > before[fk], k
        assert fused_xsect.LAUNCHES[k] == before[k], k
    assert fused_tud.LAUNCHES["tud"] > before["tud"]


def _unfused_case(dev):
    """The derived list over 695-745 cm^-1, 66 layers, on 716-726 cm^-1 at
    5e-4 through make_od_plan's shared-block plan (tile 1024, block 256)."""
    from radtxfr_tpu_torch.products.od import (_line_species_cols,
                                               layer_line_params,
                                               make_od_plan)

    f32 = torch.float32
    store = derived_lwir_linelist(695.0, 745.0, device=dev, dtype=f32)
    iso = IsoTables.load(device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(716.0, 726.0, 0.0005)
    plan = make_od_plan(store, iso, X, base)
    cols = _line_species_cols(store.host_view(), base.mol_ids)
    return plan, {p: layer_line_params(store, iso, base, cols, profile=p)
                  for p in ("voigt", "lorentz", "doppler")}


@pytest.mark.parametrize("mode", fused_xsect.UNFUSED_MODES)
def test_unfused_kernel_matches_plain(dev, mode):
    """K7 in each mode against its plain version on the same float32
    inputs (both on the card): within 2e-6 of the OD's peak (the 'full'
    spectrum for the asym and core parts; chip_smoke.py phase 3e) and of
    its own peak but for core (5e-2, a difference of near-equal float32
    shapes, K1's bound); launched once, bit-identical reruns."""
    plan, prm = _unfused_case(dev)
    p = prm[mode if mode in ("lorentz", "doppler") else "voigt"]
    n0 = fused_xsect.LAUNCHES[f"unfused_{mode}"]
    got = fused_xsect.xsect_unfused(plan, p, mode)
    torch.cuda.synchronize()
    assert fused_xsect.LAUNCHES[f"unfused_{mode}"] == n0 + 1
    assert torch.equal(got, fused_xsect.xsect_unfused(plan, p, mode))
    want = fused_xsect.xsect_unfused_plain(plan, p, mode)
    own = want.abs().max()
    peak = (fused_xsect.xsect_unfused_plain(plan, p).abs().max()
            if mode in ("asym", "core") else own)
    err = (got - want).abs().max()
    assert own > 0.0 and bool(torch.isfinite(got).all())
    assert err <= 2e-6 * peak, float(err / peak)
    assert err <= (5e-2 if mode == "core" else 2e-6) * own, float(err / own)


@pytest.mark.parametrize("name,op,n_chains", fp32_peak.SUITE)
def test_peak_probe_matches_plain(dev, name, op, n_chains):
    """Each probe mix on the card against its plain chains at both unrolled
    depths (8 and 256, 2 iterations each), within 4 float32 ulps, with the
    check operands that move every step by many ulps; the measured peak
    stays under 1.05 x the data sheet's 67 TFLOP/s (a folded chain would
    exceed it)."""
    g = torch.Generator().manual_seed(5)
    y0 = (0.25 + 0.75 * torch.rand((4096, n_chains), generator=g)).to(dev)
    ab = dict(a=fp32_peak.CHECK_A, b=fp32_peak.CHECK_B)
    for depth in (8, fp32_peak.DEPTH):
        got = fp32_peak.probe(op, depth, 2, y0, **ab)
        want = fp32_peak.probe_plain(op, depth, 2, y0.cpu(), **ab).to(dev)
        ulp = torch.finfo(torch.float32).eps * want.abs()
        assert bool(((got - want).abs() <= 4 * ulp).all()), depth
    peak, which = fp32_peak.measured_fp32_peak(dev)
    assert 0.0 < peak <= fp32_peak.FOLD_LIMIT
    assert which in [m[0] for m in fp32_peak.PEAK_MIXES]


def _k7_case(dev, n_lay=5, n_lines=600, n_pts=40001, lines=(995.0, 1105.0),
             wings=(2.0, 12.0), packed=False, block=256):
    """Random Voigt parameters of the lattice's ranges on a 0.0025 grid
    from 1000 cm^-1 (n_pts points: not a multiple of 256), sorted lines over
    ``lines`` with per-line wings drawn from ``wings`` [cm^-1], and the
    shared-block plan of plan_buckets (the last block padded where n_lines
    is not a multiple of ``block``) or a packed plan."""
    import numpy as np

    from radtxfr_tpu_torch.kernels.lineparams import LineParams

    rng = np.random.default_rng(11)
    g = fused_xsect.UniformGrid(x0=1000.0, dx=0.0025, n=n_pts)
    nu0 = np.sort(rng.uniform(*lines, n_lines))
    w = rng.uniform(*wings, n_lines)
    plan = (fused_xsect.plan_buckets_packed(nu0, g, w, tile=1024, block=32)
            if packed else
            fused_xsect.plan_buckets(nu0, g, float(w.max()), tile=1024,
                                     block=block))
    mk = lambda lo, hi: torch.as_tensor(  # noqa: E731
        rng.uniform(lo, hi, (n_lay, n_lines)), dtype=torch.float32,
        device=dev)
    t = lambda a: torch.as_tensor(  # noqa: E731
        np.tile(a, (n_lay, 1)), dtype=torch.float32, device=dev)
    zero = torch.zeros((n_lay, n_lines), device=dev)
    prm = LineParams(nu0=t(nu0), nu0_shifted=t(nu0), strength=mk(0.5, 2.0),
                     gamma_d=mk(0.0005, 0.002), gamma_0=mk(0.002, 0.1),
                     wing=t(w), shift0=mk(-0.01, 0.01), gamma_2=zero)
    return plan, prm


#: K7's edge cases: layer counts that are not a multiple of its 2 layers a
#: CTA, tiles that visit no block, padding slots, a packed plan and wings of
#: more than 2^22 grid steps (window_range takes every index)
K7_CASES = {
    "5 layers, padded last block": dict(n_lay=5),
    "66 layers": dict(n_lay=66, n_lines=200, n_pts=20001),
    "tiles with no block": dict(lines=(1040.0, 1045.0), wings=(0.5, 2.0)),
    "packed plan": dict(n_lay=3, packed=True),
    "wings over 2^22 steps": dict(n_lay=3, n_lines=40, n_pts=12001,
                                  wings=(1.1e4, 1.2e4), block=16),
}


@pytest.mark.parametrize("mode", ("full", "core", "asym"))
@pytest.mark.parametrize("case", K7_CASES)
def test_unfused_kernel_edge_cases(dev, case, mode):
    """K7 against its plain version on the edge cases of its grid and plan:
    within 2e-6 of the 'full' spectrum's peak and of its own peak but for
    core (5e-2, K1's bound; test_unfused_kernel_matches_plain); two launches
    bit-identical; a tile that visits no block writes zeros. The plain
    version runs on the CPU: on the card torch divides a tensor by a Python
    float through the float's reciprocal, so its wingu = wing / dx can be
    an ulp off the kernel's IEEE quotient and move a window edge across a
    grid point, a far-wing term of 2e-5 of the peak at a point of these
    wide-wing cases."""
    import dataclasses

    plan, prm = _k7_case(dev, **K7_CASES[case])
    if case == "tiles with no block":
        assert (plan.counts == 0).any()
    got = fused_xsect.xsect_unfused(plan, prm, mode)
    assert torch.equal(got, fused_xsect.xsect_unfused(plan, prm, mode))
    cpu = dataclasses.replace(prm, **{f.name: getattr(prm, f.name).cpu()
                                      for f in dataclasses.fields(prm)})
    want = fused_xsect.xsect_unfused_plain(plan, cpu, mode).to(dev)
    peak = fused_xsect.xsect_unfused_plain(plan, cpu).abs().max().to(dev)
    own = want.abs().max()
    err = (got - want).abs().max()
    assert own > 0.0 and bool(torch.isfinite(got).all())
    assert got.shape == (prm.strength.shape[0], plan.grid.n)
    assert err <= 2e-6 * peak, float(err / peak)
    assert err <= (5e-2 if mode == "core" else 2e-6) * own, float(err / own)
    empty = torch.as_tensor(plan.counts == 0).repeat_interleave(plan.tile)
    assert not got[:, empty[:plan.grid.n].to(dev)].any()


K3_KEYS = ("shift0", "strength", "gamma_d", "gamma_0")
SD_KEYS = K3_KEYS + ("gamma_2",)


def _k3_tangents(dev, prm, nd, kind, seed=5, keys=K3_KEYS):
    """(nd, nLay, L) tangents of ``keys`` (K3's: shift0, strength, gamma_d,
    gamma_0), each scaled like its parameter: ``dense`` non-zero on every
    layer, ``one-hot`` direction d live on layer d only (mod nLay), ``zero``
    dense but direction 1 zero everywhere."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_lay = prm["strength"].shape[0]
    mask = np.ones((nd, n_lay, 1))
    if kind == "one-hot":
        mask = np.zeros((nd, n_lay, 1))
        mask[np.arange(nd), np.arange(nd) % n_lay] = 1.0
    elif kind == "zero":
        mask[1] = 0.0
    return [torch.as_tensor(rng.standard_normal((nd,) + tuple(
        prm[k].shape)) * mask * prm[k].abs().mean().item(),
        dtype=torch.float32, device=dev).contiguous()
        for k in keys]


def _check_directions(got, want, tans, bound):
    """Each direction of a tangent kernel's output ``got`` within ``bound``
    of its own peak in ``want``; a direction with no non-zero tangent, and
    every layer a direction does not touch, exactly zero."""
    touched = torch.stack([(t != 0).any(dim=2) for t in tans]).any(dim=0)
    for d in range(got.shape[0]):
        for li in range(got.shape[1]):
            if not touched[d, li]:
                assert not got[d, li].any(), (d, li)
        own = want[d].abs().max()
        err = (got[d] - want[d]).abs().max()
        assert bool(torch.isfinite(got[d]).all())
        assert (own > 0.0) == bool(touched[d].any())
        assert err <= bound * own if own > 0 else err == 0, \
            (d, float(err / own) if own > 0 else float(err))


@pytest.mark.parametrize("nd,kind", [(1, "dense"), (1, "one-hot"),
                                     (3, "dense"), (3, "zero"),
                                     (8, "one-hot"), (8, "dense"),
                                     (8, "zero")])
def test_tangent_kernel_directions(dev, nd, kind):
    """K3 on random Voigt parameters for 1, 3 and 8 directions, one-hot
    (a direction live on one layer), dense, or with a direction zero
    everywhere: each direction within 2e-5 of its own peak
    (test_full_and_tangent_kernels_match_plain), a zero direction and every
    layer a direction does not touch exactly zero; one launch; two launches
    bit-identical."""
    dp, lay, prm = _random_case(dev, n_pts=20000)
    args = (dp, lay, prm["shift0"], prm["strength"], prm["gamma_d"],
            prm["gamma_0"], prm["wing"])
    tans = _k3_tangents(dev, prm, nd, kind)
    n0 = fused_xsect.LAUNCHES["jvp"]
    got = fused_xsect.xsect_fused_jvp(*args, *tans)
    assert fused_xsect.LAUNCHES["jvp"] == n0 + 1
    assert torch.equal(got, fused_xsect.xsect_fused_jvp(*args, *tans))
    want = fused_xsect.xsect_fused_jvp_plain(*args, *tans)
    _check_directions(got, want, tans, 2e-5)


def _ht_edge_case(dev, n_lay=5, n_lines=200, n_pts=6001,
                  lines=(995.0, 1020.0), wings=(0.5, 3.0), kind="mixed",
                  block=32):
    """Random HT parameters on a 0.0025 grid from 1000 cm^-1 (n_pts points:
    not a multiple of K5's 128-point slice), sorted lines over ``lines`` with
    per-line wings drawn from ``wings`` [cm^-1] and the HT builders' packed
    plan (tile 128, ``block`` slots: padding where a tile holds fewer
    lines), on the card and on the CPU. ``kind``: 'part1' (Gamma2 = Shift2
    = 0), 'part4' (Gamma2 live, Shift2 = 0, eta real: c2t and csqrtY real,
    the kernels' closed-form Weideman ranges), 'complex' (Gamma2 live, a
    complex eta) or 'mixed' (a third of each, Shift2 live on the complex
    third). Returns (card args, CPU args) of the HT pass:
    (dplan, lay_idx, strength, wing, consts)."""
    import numpy as np

    from radtxfr_tpu_torch.kernels.htp_real import (HT_CONST_KEYS,
                                                    ht_line_constants)

    rng = np.random.default_rng(13)
    g = fused_xsect.UniformGrid(x0=1000.0, dx=0.0025, n=n_pts)
    nu0 = np.sort(rng.uniform(*lines, n_lines))
    w = rng.uniform(*wings, n_lines)
    plan = fused_xsect.plan_buckets_packed(nu0, g, w, tile=128, block=block)
    part = {"part1": np.zeros(n_lines, int), "part4": np.ones(n_lines, int),
            "complex": np.full(n_lines, 2)}.get(kind, rng.integers(0, 3,
                                                                   n_lines))
    mk = lambda lo, hi, m=1.0: torch.as_tensor(  # noqa: E731
        rng.uniform(lo, hi, (n_lay, n_lines)) * m, dtype=torch.float64)
    g0 = mk(0.002, 0.1)
    k = ht_line_constants(mk(0.0005, 0.002), g0, g0 * mk(0.05, 0.15,
                                                         part > 0),
                          mk(-0.01, 0.01), mk(-5e-4, 5e-4, part == 2),
                          mk(0.0, 0.05, part > 0), mk(0.0, 0.3, part > 0),
                          mk(-0.05, 0.05, part == 2))
    host = ([mk(0.5, 2.0), torch.as_tensor(np.tile(w, (n_lay, 1)))]
            + [k[key] for key in HT_CONST_KEYS])
    out = []
    for d in (dev, torch.device("cpu")):
        dp = fused_xsect.device_plan(plan, np.arange(n_lines), nu0, device=d)
        s, wing, *consts = [t.to(device=d, dtype=torch.float32).contiguous()
                            for t in host]
        out.append((dp, torch.arange(n_lay, dtype=torch.int32, device=d), s,
                    wing, consts))
    return out


#: K5's edge cases: layer counts that are not a multiple of its 4 rows a
#: CTA, tiles that visit no block, padding slots, n_out not a multiple of
#: the slice, each kind of pair
HT_CASES = {
    "5 layers, mixed": dict(n_lay=5),
    "10 layers, PART4 real": dict(n_lay=10, kind="part4"),
    "66 layers, PART1": dict(n_lay=66, n_lines=60, n_pts=3001,
                             kind="part1"),
    "66 layers, mixed": dict(n_lay=66, n_lines=60, n_pts=3001),
    "tiles with no block, complex eta": dict(lines=(1003.0, 1006.0),
                                             wings=(0.2, 1.0),
                                             kind="complex"),
}


@pytest.mark.parametrize("case", HT_CASES)
def test_ht_kernel_edge_cases(dev, case):
    """K5 against its plain version on the edge cases of its grid, plan and
    pairs: within 2e-6 of its own peak (test_ht_kernel_matches_plain); one
    launch; two launches bit-identical; a tile that visits no block writes
    zeros. The plain version runs on the card, as in
    test_ht_kernel_matches_plain: torch's float32 square root on the CPU is
    not correctly rounded at every near-tie (66.5029259518 in float64
    rounds to 66.50292206 there, to 66.50292969 in IEEE), and csqrt's
    Im sqrt(X + Y) = sqrt((|X + Y| - Re(X + Y))/2) cancels, so one such ulp
    at one point of the PART4 case moves the CPU's output by 4.6e-5 of the
    peak from both the kernel's and the card's plain version."""
    from radtxfr_tpu_torch.kernels import fused_ht

    (dp, lay, s, w, consts), _ = _ht_edge_case(dev, **HT_CASES[case])
    n0 = fused_xsect.LAUNCHES["ht"]
    got = fused_ht.xsect_ht(dp, lay, s, w, consts)
    assert fused_xsect.LAUNCHES["ht"] == n0 + 1
    assert torch.equal(got, fused_ht.xsect_ht(dp, lay, s, w, consts))
    want = fused_ht.xsect_ht_plain(dp, lay, s, w, consts)
    own = want.abs().max()
    err = (got - want).abs().max()
    assert own > 0.0 and bool(torch.isfinite(got).all())
    assert got.shape == (lay.numel(), dp.n_out)
    assert err <= 2e-6 * own, float(err / own)
    empty = (dp.counts == 0).repeat_interleave(dp.tile)[:dp.n_out]
    if case.startswith("tiles with no block"):
        assert bool(empty.any())
    assert not got[:, empty].any()


def _ht_tangents(prm, nd, kind, seed=17):
    """(nd, nLay, L) tangents of the strength and the 11 HT constants, each
    scaled like its parameter, as K3's (_k3_tangents): 'dense', 'one-hot'
    (direction d live on layer d only, mod nLay) or 'zero' (dense,
    direction 1 zero everywhere); float64 on the CPU."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n_lay = prm[0].shape[0]
    mask = np.ones((nd, n_lay, 1))
    if kind == "one-hot":
        mask = np.zeros((nd, n_lay, 1))
        mask[np.arange(nd), np.arange(nd) % n_lay] = 1.0
    elif kind == "zero":
        mask[1] = 0.0
    return [torch.as_tensor(rng.standard_normal((nd,) + tuple(p.shape))
                            * mask * p.abs().mean().item())
            for p in prm]


@pytest.mark.parametrize("nd,kind", [(1, "dense"), (1, "one-hot"),
                                     (3, "dense"), (3, "zero"),
                                     (8, "one-hot"), (8, "dense"),
                                     (8, "zero")])
def test_ht_tangent_kernel_directions(dev, nd, kind):
    """K6 on random HT parameters (each kind of pair) for 1, 3 and 8
    directions, one-hot, dense, or with a direction zero everywhere: each
    direction within 2e-6 of its own peak against its plain version on the
    card (test_ht_tangent_kernel_matches_plain; the CPU's float32 square
    root is not correctly rounded at every near-tie,
    test_ht_kernel_edge_cases), a zero direction and every layer a
    direction does not touch exactly zero; one launch; two launches
    bit-identical."""
    from radtxfr_tpu_torch.kernels import fused_ht

    (dp, lay, s, w, consts), (_, _, sc, _, cc) = _ht_edge_case(
        dev, n_lay=5, n_lines=120, n_pts=4001, lines=(997.0, 1012.0))
    tans = _ht_tangents([sc, *cc], nd, kind)
    t_dev = [t.to(device=dev, dtype=torch.float32).contiguous()
             for t in tans]
    n0 = fused_xsect.LAUNCHES["ht_jvp"]
    got = fused_ht.xsect_ht_jvp(dp, lay, s, w, consts, t_dev[0], t_dev[1:])
    assert fused_xsect.LAUNCHES["ht_jvp"] == n0 + 1
    assert torch.equal(got, fused_ht.xsect_ht_jvp(dp, lay, s, w, consts,
                                                  t_dev[0], t_dev[1:]))
    want = fused_ht.xsect_ht_jvp_plain(dp, lay, s, w, consts, t_dev[0],
                                       t_dev[1:])
    _check_directions(got, want, tans, 2e-6)


@pytest.mark.parametrize("nd,kind", [(1, "dense"), (1, "one-hot"),
                                     (3, "dense"), (3, "zero"),
                                     (8, "one-hot"), (8, "dense"),
                                     (8, "zero")])
def test_sdvoigt_tangent_kernel_directions(dev, nd, kind):
    """K4 on random SD-Voigt parameters for 1, 3 and 8 directions, one-hot
    (a direction live on one layer), dense, or with a direction zero
    everywhere: each direction within 2e-5 of its own peak
    (test_sdvoigt_tangent_kernel_matches_plain), a zero direction and every
    layer a direction does not touch exactly zero; one launch; two launches
    bit-identical."""
    dp, lay, prm = _random_case(dev, n_pts=20000)
    args = (dp, lay, prm["shift0"], prm["strength"], prm["gamma_d"],
            prm["gamma_0"], prm["gamma_2"], prm["wing"])
    tans = _k3_tangents(dev, prm, nd, kind, keys=SD_KEYS)
    n0 = fused_xsect.LAUNCHES["sdvoigt_jvp"]
    got = fused_xsect.xsect_sdvoigt_jvp(*args, *tans)
    assert fused_xsect.LAUNCHES["sdvoigt_jvp"] == n0 + 1
    assert torch.equal(got, fused_xsect.xsect_sdvoigt_jvp(*args, *tans))
    want = fused_xsect.xsect_sdvoigt_jvp_plain(*args, *tans)
    _check_directions(got, want, tans, 2e-5)


def _sd_edge_case(dev, n_lay=5, n_lines=200, n_pts=6001,
                  lines=(995.0, 1020.0), wings=(0.5, 3.0), clamp=0.3,
                  block=32, tile=128):
    """Random SD-Voigt parameters (_random_case's ranges) on a 0.0025 grid
    from 1000 cm^-1 (n_pts points: not a multiple of K4's 128-point slice),
    sorted lines over ``lines`` with per-line wings drawn from ``wings``
    [cm^-1] and a packed plan (``tile``, ``block`` slots: padding where a
    tile holds fewer lines); a share ``clamp`` of the (layer, line) pairs
    with Gamma2 below 1e-4 Gamma0, in the Voigt-limit clamp. Returns the
    plan, the layer indices and the parameters."""
    import numpy as np

    rng = np.random.default_rng(19)
    g = fused_xsect.UniformGrid(x0=1000.0, dx=0.0025, n=n_pts)
    nu0 = np.sort(rng.uniform(*lines, n_lines))
    w = rng.uniform(*wings, n_lines)
    plan = fused_xsect.plan_buckets_packed(nu0, g, w, tile=tile, block=block)
    dp = fused_xsect.device_plan(plan, np.arange(n_lines), nu0, device=dev)
    shape = (n_lay, n_lines)
    mk = lambda lo, hi: rng.uniform(lo, hi, shape)  # noqa: E731
    g0 = mk(0.002, 0.1)
    ratio = np.where(rng.random(shape) < clamp, mk(0.0, 5e-5),
                     mk(0.05, 0.15))
    host = dict(shift0=mk(-0.01, 0.01), strength=mk(0.5, 2.0),
                gamma_d=mk(0.0005, 0.002), gamma_0=g0, gamma_2=g0 * ratio,
                wing=np.tile(w, (n_lay, 1)))
    prm = {k: torch.as_tensor(v, dtype=torch.float32, device=dev)
           for k, v in host.items()}
    return dp, torch.arange(n_lay, dtype=torch.int32, device=dev), prm


#: K4's edge cases: layer counts that are not a multiple of its 4 rows a
#: CTA, tiles that visit no block, padding slots, n_out not a multiple of
#: the slice, pairs in the Voigt-limit clamp, a shift0-only tangent
SD_CASES = {
    "5 layers, clamp": dict(n_lay=5),
    "66 layers, tile 512": dict(n_lay=66, n_lines=60, n_pts=3001, tile=512),
    "7 layers, 64-slot blocks": dict(n_lay=7, block=64, n_pts=4001),
    "tiles with no block": dict(lines=(1003.0, 1006.0), wings=(0.2, 1.0)),
    "all clamped, shift0 only": dict(n_lay=6, clamp=1.0),
}


@pytest.mark.parametrize("case", SD_CASES)
def test_sdvoigt_tangent_kernel_edge_cases(dev, case):
    """K4 against its plain version on the edge cases of its grid, plan,
    pairs and tangents, 3 directions (one-hot, with the shift0 tangent
    alone in the last case): each direction within 2e-5 of its own peak,
    untouched rows exactly zero (_check_directions); one launch; two
    launches bit-identical; a tile that visits no block writes zeros."""
    dp, lay, prm = _sd_edge_case(dev, **SD_CASES[case])
    args = (dp, lay, prm["shift0"], prm["strength"], prm["gamma_d"],
            prm["gamma_0"], prm["gamma_2"], prm["wing"])
    tans = _k3_tangents(dev, prm, 3, "one-hot", seed=23, keys=SD_KEYS)
    if case.endswith("shift0 only"):
        tans = [tans[0]] + [torch.zeros_like(t) for t in tans[1:]]
    n0 = fused_xsect.LAUNCHES["sdvoigt_jvp"]
    got = fused_xsect.xsect_sdvoigt_jvp(*args, *tans)
    assert fused_xsect.LAUNCHES["sdvoigt_jvp"] == n0 + 1
    assert got.shape == (3, lay.numel(), dp.n_out)
    assert torch.equal(got, fused_xsect.xsect_sdvoigt_jvp(*args, *tans))
    want = fused_xsect.xsect_sdvoigt_jvp_plain(*args, *tans)
    _check_directions(got, want, tans, 2e-5)
    empty = (dp.counts == 0).repeat_interleave(dp.tile)[:dp.n_out]
    if case.startswith("tiles with no block"):
        assert bool(empty.any())
    assert not got[:, :, empty].any()


#: a spectral shard of _random_case's tiles (512 points; 79 tiles, the last
#: partial), in a weighted partition's non-contiguous order
SHARD_TILES = (60, 3, 41, 42, 77)


def _shard(dp, tiles=SHARD_TILES):
    """The shard-local overrides of ``tiles``: their blocks, and the global
    grid offset of each (its global first point minus its local one)."""
    t = torch.as_tensor(tiles, device=dp.starts.device)
    local = torch.arange(len(tiles), device=t.device)
    return dict(starts=dp.starts[t], counts=dp.counts[t],
                k_offset=((t - local) * dp.tile).to(torch.int32),
                n_tiles=len(tiles), n_out=len(tiles) * dp.tile)


def _columns(full, dp, tiles=SHARD_TILES):
    idx = (torch.as_tensor(tiles, device=full.device)[:, None] * dp.tile
           + torch.arange(dp.tile, device=full.device)).reshape(-1)
    return full[..., idx]


@pytest.mark.parametrize("mode", ("asym", "core", "mix", "full", "sdvoigt",
                                  "corr:64:voigt"))
def test_offset_kernel_matches_plain(dev, mode):
    """K1 on a shard's tiles with their per-tile grid offsets against its
    plain version with the same overrides (2e-6 of the pass's own peak; 5e-2
    for core, chip_smoke.K1_OWN_BOUND), counted as an offset launch, and
    bit-identical to the matching columns of the unsharded launch."""
    dp, lay, prm = _random_case(dev)
    g2 = prm.pop("gamma_2")
    ymix = prm["gamma_0"] * 3.0 if mode == "mix" else None
    sh = _shard(dp)
    n0 = fused_xsect.OFFSET_LAUNCHES[mode]
    got = fused_xsect.xsect_fused(dp, lay, *prm.values(), ymix, mode,
                                  gamma_2=g2, **sh)
    assert fused_xsect.OFFSET_LAUNCHES[mode] == n0 + 1
    want = fused_xsect.xsect_fused_plain(dp, lay, *prm.values(), ymix, mode,
                                         gamma_2=g2, **sh)
    own = want.abs().max()
    assert own > 0.0 and bool(torch.isfinite(got).all())
    bound = 5e-2 if mode == "core" else 2e-6
    assert (got - want).abs().max() <= bound * own, \
        float((got - want).abs().max() / own)
    full = fused_xsect.xsect_fused(dp, lay, *prm.values(), ymix, mode,
                                   gamma_2=g2)
    assert torch.equal(got, _columns(full, dp))


@pytest.mark.parametrize("kernel", ("K3", "K4"))
def test_offset_tangent_kernels_match_plain(dev, kernel):
    """K3 and K4 on a shard's tiles with their offsets, 3 directions:
    within 2e-5 of each direction's own peak of the plain version with the
    same overrides, and bit-identical to the unsharded launch's columns."""
    dp, lay, prm = _random_case(dev, n_pts=20000)
    sh = _shard(dp, (30, 2, 17, 18, 38))
    tans = _sd_tangents(dev, prm, 3)
    if kernel == "K3":
        args = (dp, lay, prm["shift0"], prm["strength"], prm["gamma_d"],
                prm["gamma_0"], prm["wing"])
        tans = tans[:4]
        run, plain = (fused_xsect.xsect_fused_jvp,
                      fused_xsect.xsect_fused_jvp_plain)
    else:
        args = (dp, lay, prm["shift0"], prm["strength"], prm["gamma_d"],
                prm["gamma_0"], prm["gamma_2"], prm["wing"])
        run, plain = (fused_xsect.xsect_sdvoigt_jvp,
                      fused_xsect.xsect_sdvoigt_jvp_plain)
    got = run(*args, *tans, **sh)
    want = plain(*args, *tans, **sh)
    for d in range(3):
        own = want[d].abs().max()
        assert own > 0.0
        assert (got[d] - want[d]).abs().max() <= 2e-5 * own
    assert torch.equal(got, _columns(run(*args, *tans), dp,
                                     (30, 2, 17, 18, 38)))


def test_ht_kernels_zero_offset_bit_identical(dev):
    """K5 and K6 take the row skeleton's tile offsets (every caller passes
    none, as in JAX): a plan whose tiles carry zero offsets gives the bits
    of the launch without; a tile_off of another dtype raises."""
    import dataclasses

    from radtxfr_tpu_torch.kernels import fused_ht

    dp, lay, s, w, consts = _ht_case(dev, n_pts=8000)
    z = dataclasses.replace(dp, tile_off=torch.zeros(
        dp.n_tiles, dtype=torch.int32, device=dev))
    assert torch.equal(fused_ht.xsect_ht(z, lay, s, w, consts),
                       fused_ht.xsect_ht(dp, lay, s, w, consts))
    gen = torch.Generator(device=dev).manual_seed(9)
    s_t = (torch.randn((2,) + tuple(s.shape), generator=gen, device=dev)
           * s.abs().mean()).contiguous()
    c_t = [torch.zeros((2,) + tuple(c.shape), device=dev) for c in consts]
    assert torch.equal(
        fused_ht.xsect_ht_jvp(z, lay, s, w, consts, s_t, c_t),
        fused_ht.xsect_ht_jvp(dp, lay, s, w, consts, s_t, c_t))
    bad = dataclasses.replace(dp, tile_off=z.tile_off.long())
    with pytest.raises(TypeError, match="int32"):
        fused_ht.xsect_ht(bad, lay, s, w, consts)


def test_builders_take_a_grid_tensor_on_the_card(dev):
    """``compute_od_layers(engine="pallas")`` (through ``make_od_fn``) and
    ``make_xsect_fn`` take the grid as a tensor on the card, as the JAX
    builders take a device array, with the bits of a host grid."""
    from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
    from radtxfr_tpu_torch.products.od import (compute_od_layers,
                                               make_xsect_fn)

    X = arange_drift_free(800.0, 805.0, 0.005)
    grid = torch.as_tensor(X, dtype=torch.float32, device=dev)
    lines = synthetic_lines(200, nu_min=790.0, nu_max=815.0, seed=2,
                            device=dev)
    iso = IsoTables.load(device=dev)
    atm = std_atmosphere(device=dev)
    assert torch.equal(
        compute_od_layers(lines, iso, grid, atm, engine="pallas"),
        compute_od_layers(lines, iso, X, atm, engine="pallas"))
    T = torch.tensor([250.0, 290.0], device=dev)
    p = torch.tensor([0.5, 1.0], device=dev)
    assert torch.equal(make_xsect_fn(lines, iso, grid, T.cpu(), p.cpu())(T, p),
                       make_xsect_fn(lines, iso, X, T.cpu(), p.cpu())(T, p))


def test_od_from_xs_on_the_card(dev):
    """``od_from_xs`` on the card (float32) against the CPU's float64 on
    the same table and states within 1e-6 of peak (the standard atmosphere
    leaves the lattice on both axes: the clamped edges too); TF32 for
    ``precision="default"`` only, the package's setting (off) restored."""
    import dataclasses

    import numpy as np

    from radtxfr_tpu_torch.products.od_from_xs import XsTable, od_from_xs

    rng = np.random.default_rng(4)
    sigma = rng.uniform(0.0, 1e-21, (2, 4, 3, 50001)).astype(np.float32)
    T = np.array([230.0, 260.0, 290.0, 320.0])
    logp = np.log(np.array([0.2, 0.6, 1.0]))
    x = np.linspace(800.0, 1300.0, 50001)
    card = XsTable.from_numpy(sigma, T, logp, x, (1, 2), device=dev)
    host = XsTable.from_numpy(sigma, T, logp, x, (1, 2), device="cpu",
                              dtype=torch.float64)
    atm = std_atmosphere(device=dev)
    atm64 = dataclasses.replace(atm, **{
        f: getattr(atm, f).double().cpu()
        for f in ("z0", "z1", "pl", "p", "T", "vmr")})
    got = od_from_xs(card, atm)
    want = od_from_xs(host, atm64)
    assert got.shape == (66, 50001) and got.device.type == "cuda"
    assert (got.double().cpu() - want).abs().max() <= 1e-6 * want.abs().max()
    fast = od_from_xs(card, atm, precision="default")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert (fast - got).abs().max() <= 1e-2 * got.abs().max()


@pytest.mark.parametrize("af_wing", [2.0, 2.0025])      # 802 and 803 taps
def test_convolve_spectrum_on_the_card(dev, af_wing):
    """``convolve_spectrum`` (float64 ``conv1d`` with NumPy's 'same'
    centring) on the card against the CPU within 1e-12 of peak, at an even
    and an odd slit length, with each hapi slit."""
    import numpy as np

    from radtxfr_tpu_torch.kernels.spectra import (HAPI_SLITS,
                                                   convolve_spectrum)

    omega = np.arange(4001) * 0.005 + 800.0
    y = np.exp(-0.5 * ((omega - 810.0) / 0.5) ** 2) + 0.1 * np.sin(omega)
    for slit in HAPI_SLITS:
        got = convolve_spectrum(omega, torch.as_tensor(y, device=dev),
                                resolution=0.4, af_wing=af_wing, slit=slit)
        want = convolve_spectrum(omega, torch.as_tensor(y),
                                 resolution=0.4, af_wing=af_wing, slit=slit)
        assert got[1].device.type == "cuda" and got[2:4] == want[2:4]
        err = (got[1].cpu() - want[1]).abs().max()
        assert err <= 1e-12 * want[1].abs().max(), slit


def test_hapi_sdvoigt_driver_on_the_card(dev, tmp_path):
    """``absorptionCoefficient_SDVoigt`` with the database on the card
    against the same call on the CPU (both float64) within 1e-7 of peak
    (pcqsdhc's cancellation beside its PART4 thresholds, ROADMAP
    caveat); NumPy out, the intensity threshold's mask the same on both."""
    import numpy as np

    from radtxfr_tpu_torch import hapi_compat as hc
    from radtxfr_tpu_torch.lines.hapi_db import save_table
    from radtxfr_tpu_torch.lines.synthetic import synthetic_lines

    save_table(synthetic_lines(300, 995.0, 1015.0, seed=3, device="cpu"),
               str(tmp_path), "t")
    kw = dict(SourceTables="t", Components=[(1, 1), (2, 1)],
              Environment={"T": 275.0, "p": 0.85}, OmegaStep=0.0025,
              OmegaRange=(1000.0, 1010.0), OmegaWing=5.0,
              IntensityThreshold=1e-24)
    out = {}
    saved = hc._DEVICE
    try:
        for where in ("cpu", dev):
            hc._TABLES.clear()
            hc._EXTRAS.clear()
            hc.db_begin(str(tmp_path), device=where)
            assert hc._get_table("t").sw.device.type == \
                torch.device(where).type
            out[str(where)] = hc.absorptionCoefficient_SDVoigt(**kw)
    finally:
        hc._TABLES.clear()
        hc._EXTRAS.clear()
        hc._DEVICE = saved
    (nu, k), (nu_c, k_c) = out["cpu"], out[str(dev)]
    assert isinstance(k_c, np.ndarray) and k_c.max() > 0
    np.testing.assert_array_equal(nu, nu_c)
    assert np.abs(k_c - k).max() <= 1e-7 * np.abs(k).max()


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, whose ``recorded_h5``
    (h5py, or a recording stand-in where it is absent) this file shares."""
    import os
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if root not in sys.path:
        sys.path.insert(0, root)
    import chip_smoke

    return chip_smoke


def test_products_chain_on_card_tensors(dev, tmp_path):
    """The port's products chained on the card as JAX's chain on a device:
    ``make_tud_fn`` on the state's card ``z0`` and card altitudes ->
    ``ils_mako(t.X, t.tau)`` -> ``reduce_operator(t.X, 0.25)`` on
    ``t.tau`` -> ``write_h5`` -> ``EnsembleCheckpoint.write_batch``, every
    step fed card tensors and bit-identical to the same call on host
    copies."""
    import numpy as np

    from radtxfr_tpu_torch.dist.checkpoint import EnsembleCheckpoint
    from radtxfr_tpu_torch.io.h5 import Var
    from radtxfr_tpu_torch.sensor.ils import ils_mako

    f32 = torch.float32
    store = derived_lwir_linelist(755.0, 825.0, device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(780.0, 800.0, 0.0005)
    od_fn = make_od_fn(store, IsoTables.load(device=dev, dtype=f32), X, base,
                       continuum="mt_ckd")
    od = od_fn(base.T, base.p, base.pl, base.vmr)
    x = torch.as_tensor(X, dtype=f32, device=dev)
    alts = [1.0, 500.0]
    t = make_tud_fn(base.z0, torch.tensor(alts, device=dev), device=dev)(
        x, od, base.T)
    t_h = make_tud_fn(base.z0.cpu().numpy(), alts, device=dev)(x, od, base.T)
    for k in ("X", "tau", "Lu", "Ld"):
        assert getattr(t, k).device.type == dev.type
        assert torch.equal(getattr(t, k), getattr(t_h, k)), k
    host_x = t.X.cpu().numpy()
    (cx, cy), (hx, hy) = ils_mako(t.X, t.tau), ils_mako(host_x, t.tau)
    assert cy.device.type == dev.type and cx.size >= 2
    np.testing.assert_array_equal(cx, hx)
    assert torch.equal(cy, hy)
    op = reduce_operator(t.X, 0.25, device=dev)
    op_h = reduce_operator(host_x, 0.25, device=dev)
    np.testing.assert_array_equal(op.x_out, op_h.x_out)
    red = op(t.tau)
    assert red.device.type == dev.type and torch.equal(red, op_h(t.tau))
    card = {"X": Var(torch.as_tensor(op.x_out), units="cm^{-1}"),
            "tau": Var(red, units="none"), "Ld": t.Ld, "mako": cy}
    host = {k: (Var(v.data.cpu().numpy(), units=v.units)
                if isinstance(v, Var) else v.cpu().numpy())
            for k, v in card.items()}
    smoke = _chip_smoke()
    got = smoke.recorded_h5(str(tmp_path / "card.h5"), card)
    want = smoke.recorded_h5(str(tmp_path / "host.h5"), host)
    assert set(got) == set(want) == set(card)
    for k in got:
        assert smoke.same_bits(got[k][0], want[k][0]), k
        assert got[k][1] == want[k][1]
    arrays = {"tau": red, "Lu": op(t.Lu), "Ld": op(t.Ld)}
    for name, a in (("card", arrays),
                    ("host", {k: v.cpu().numpy() for k, v in arrays.items()})):
        EnsembleCheckpoint(str(tmp_path / name), 1, 1).write_batch(0, a)
    got, want = (EnsembleCheckpoint(str(tmp_path / n), 1, 1).read_batch(0)
                 for n in ("card", "host"))
    for k in arrays:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes(), k


def test_production_member_from_numpy_inputs(dev):
    """``chip_smoke.py``'s NumPy-input member (phase 5e) on a 20 cm^-1
    band: the state's columns as host NumPy into the OD function, the host
    axis into ``make_tud_fn``'s function and ``tud_from_od``, host
    tau/Lu/Ld into the reduction operator and ``reduce_resolution``; each
    result on the card and bit-identical to the same call on the card
    tensors."""
    f32 = torch.float32
    store = derived_lwir_linelist(755.0, 825.0, device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(780.0, 800.0, 0.0005)
    od_fn = make_od_fn(store, IsoTables.load(device=dev, dtype=f32), X, base,
                       continuum="mt_ckd")
    od = od_fn(base.T, base.p, base.pl, base.vmr)
    x = torch.as_tensor(X, dtype=f32, device=dev)
    smoke = _chip_smoke()
    t = make_tud_fn(base.z0, torch.as_tensor(smoke.ALTITUDES, device=dev),
                    device=dev)(x, od, base.T)
    op = reduce_operator(t.X, 0.25, device=dev)
    smoke.numpy_member(str(dev), base, od_fn, od, x, t, op)


def test_scalar_and_list_arguments_follow_the_call(dev):
    """A Python scalar or list where an array may stand goes where a NumPy
    array would: onto the card by default, or onto a tensor argument's
    device; ``device="cpu"`` keeps the call on the CPU."""
    import numpy as np

    from radtxfr_tpu_torch.kernels import faddeeva, htp
    from radtxfr_tpu_torch.scene import robust

    y = np.linspace(0.01, 3.0, 64)
    for name in ("cpf3", "cpf_humlicek", "cef", "wofz_real_series_only"):
        fn = getattr(faddeeva, name)
        for args in ((1.5, y), (1.5, 0.25), (1.5, torch.as_tensor(y,
                                                                device=dev))):
            out = fn(*args)
            for leaf in out if isinstance(out, tuple) else (out,):
                assert leaf.device.type == "cuda", (name, leaf.device)
        out = fn(1.5, y, device="cpu")
        assert (out[0] if isinstance(out, tuple) else out).device.type == \
            "cpu"
    params = [1000.0, 0.0012, 0.07, 0.007, -0.002, 1e-4, 0.02, 0.15]
    for p in (params, [np.array(v) for v in params]):
        re, im = htp.pcqsdhc(*p, 1000.01)
        assert re.device.type == im.device.type == "cuda"
    re, _ = htp.pcqsdhc(*params, 1000.01, device="cpu")
    assert re.device.type == "cpu"
    assert robust.mad([1.0, 2.0, 5.0]).device.type == "cuda"
    assert robust.mad([1.0, 2.0, 5.0], device="cpu").device.type == "cpu"


# ---- the fast reciprocal (fast=True, JAX's fast_rcp) ------------------------

def _fast_check(label, fast, ieee, want, bound, peak=None):
    """The FAST instantiation's output ``fast`` against the plain version
    of its arithmetic ``want`` (``fast=True``: on the card, the FAST
    instantiation's reciprocal, ``fused_xsect.card_fast_rcp``) within
    ``bound`` of ``peak`` (the plain output's own peak by default), both
    finite; its largest difference from the IEEE instantiation's output
    ``ieee`` printed as a share of the same peak."""
    peak = want.abs().max() if peak is None else peak
    assert peak > 0.0 and bool(torch.isfinite(fast).all())
    err = float((fast - want).abs().max() / peak)
    gap = float((fast - ieee).abs().max() / peak)
    print(f"[fast_rcp] {label}: FAST vs plain {err:.3e}, FAST vs IEEE "
          f"{gap:.3e} of peak (bound {bound:g})")
    assert err <= bound, (label, err)


def _launched(before, key, n):
    """``key`` launched n times since ``before`` in its FAST instantiation
    and never in its IEEE one (no fallback)."""
    fk = fused_xsect.launch_key(key, True)
    assert fused_xsect.LAUNCHES[fk] - before[fk] == n, key
    assert fused_xsect.LAUNCHES[key] == before[key], key


def test_card_fast_rcp_table(dev):
    """The card's rcp.approx.f32 table (``fused_xsect.fast_rcp_table``):
    each entry within one ulp of IEEE 1/x on [1, 2); the plain versions'
    fast reciprocal built from it (``card_fast_rcp``) within two ulps of
    IEEE 1/x over random normal floats of every exponent, and equal to the
    Newton step on the table's own entries in [1, 2)."""
    tb = fused_xsect.fast_rcp_table(dev)
    assert tb.shape == (1 << 23,) and tb.dtype == torch.int32
    one = (torch.arange(1 << 23, dtype=torch.int32, device=dev)
           | 0x3F800000).view(torch.float32)
    ulps = (tb - (1.0 / one).view(torch.int32)).abs()
    assert int(ulps.max()) <= 1
    r0 = tb.view(torch.float32)
    assert torch.equal(fused_xsect.card_fast_rcp(one), r0 * (2.0 - one * r0))
    g = torch.Generator(device=dev).manual_seed(18)
    x = torch.randn(1 << 20, generator=g, device=dev) * torch.exp2(
        torch.randint(-120, 120, (1 << 20,), generator=g, device=dev
                      ).float())
    x = x[x.abs() >= torch.finfo(torch.float32).tiny]
    ulps = (fused_xsect.card_fast_rcp(x).view(torch.int32)
            - (1.0 / x).view(torch.int32)).abs()
    assert int(ulps.max()) <= 2


@pytest.mark.parametrize("mode", ("full",) + NEW_MODES)
def test_fast_k1_modes_match_plain(dev, mode):
    """K1's FAST instantiation in ``full`` and each mode of the XS lattice
    on random parameters against its plain version within 2e-6 of the
    pass's own peak (test_xs_lattice_modes_match_plain's bound), launched
    once under its FAST key; bit-identical reruns."""
    dp, lay, prm = _random_case(dev)
    g2 = prm.pop("gamma_2")
    run = lambda fast: fused_xsect.xsect_fused(  # noqa: E731
        dp, lay, *prm.values(), None, mode, gamma_2=g2, fast=fast)
    before = Counter(fused_xsect.LAUNCHES)
    got = run(True)
    torch.cuda.synchronize()
    _launched(before, mode, 1)
    assert torch.equal(got, run(True))
    want = fused_xsect.xsect_fused_plain(dp, lay, *prm.values(), None, mode,
                                         gamma_2=g2, fast=True)
    _fast_check(f"K1 {mode}", got, run(False), want, 2e-6)


@pytest.mark.parametrize("mode", fused_xsect.UNFUSED_MODES)
def test_fast_k7_matches_plain(dev, mode):
    """K7's FAST instantiation in each mode against its plain version at
    test_unfused_kernel_matches_plain's bounds, launched once under its
    FAST key, and through compute_od_layers' prebuilt-plan route with
    pallas_opts={'fast_rcp': True} (full), bit-identical to the direct
    call."""
    from radtxfr_tpu_torch.products.od import compute_od_layers

    plan, prm = _unfused_case(dev)
    p = prm[mode if mode in ("lorentz", "doppler") else "voigt"]
    before = Counter(fused_xsect.LAUNCHES)
    got = fused_xsect.xsect_unfused(plan, p, mode, fast=True)
    torch.cuda.synchronize()
    _launched(before, f"unfused_{mode}", 1)
    assert torch.equal(got, fused_xsect.xsect_unfused(plan, p, mode,
                                                      fast=True))
    want = fused_xsect.xsect_unfused_plain(plan, p, mode, fast=True)
    ieee = fused_xsect.xsect_unfused(plan, p, mode)
    peak = (fused_xsect.xsect_unfused_plain(plan, p).abs().max()
            if mode in ("asym", "core") else want.abs().max())
    _fast_check(f"K7 {mode}", got, ieee, want, 2e-6, peak)
    _fast_check(f"K7 {mode} (own peak)", got, ieee, want,
                5e-2 if mode == "core" else 2e-6)
    if mode == "full":
        f32 = torch.float32
        store = derived_lwir_linelist(695.0, 745.0, device=dev, dtype=f32)
        base = std_atmosphere(device=dev, dtype=f32)
        X = arange_drift_free(716.0, 726.0, 0.0005)
        route = compute_od_layers(store, IsoTables.load(device=dev, dtype=f32),
                                  X, base, engine="pallas", plan=plan,
                                  pallas_opts={"fast_rcp": True})
        assert torch.equal(route, got)


def test_fast_tangent_and_ht_kernels_match_plain(dev):
    """K3, K4 and K5 in their FAST instantiations on random parameters
    against their plain versions (K3 and K4: each of 3 directions within
    2e-5 of its own peak; K5 within 2e-6 of the pass's peak: the bounds of
    their IEEE tests above), each launched under its FAST key; K6 has no
    FAST build (its entry raises) and the differentiable HT pass with
    fast=True runs K5 FAST and K6 IEEE, as JAX's."""
    from radtxfr_tpu_torch import _build
    from radtxfr_tpu_torch.kernels import fused_ht

    dp, lay, prm = _random_case(dev, n_pts=20000)
    tans = _sd_tangents(dev, prm, 3)
    k3 = (dp, lay, prm["shift0"], prm["strength"], prm["gamma_d"],
          prm["gamma_0"], prm["wing"])
    k4 = (dp, lay, prm["shift0"], prm["strength"], prm["gamma_d"],
          prm["gamma_0"], prm["gamma_2"], prm["wing"])
    for name, key, fn, plain, args, t in (
            ("K3", "jvp", fused_xsect.xsect_fused_jvp,
             fused_xsect.xsect_fused_jvp_plain, k3, tans[:4]),
            ("K4", "sdvoigt_jvp", fused_xsect.xsect_sdvoigt_jvp,
             fused_xsect.xsect_sdvoigt_jvp_plain, k4, tans)):
        before = Counter(fused_xsect.LAUNCHES)
        got = fn(*args, *t, fast=True)
        torch.cuda.synchronize()
        _launched(before, key, 1)
        assert torch.equal(got, fn(*args, *t, fast=True))
        want, ieee = plain(*args, *t, fast=True), fn(*args, *t)
        for d in range(3):
            _fast_check(f"{name} direction {d}", got[d], ieee[d], want[d],
                        2e-5)

    dp, lay, s, w, consts = _ht_case(dev)
    before = Counter(fused_xsect.LAUNCHES)
    got = fused_ht.xsect_ht(dp, lay, s, w, consts, fast=True)
    torch.cuda.synchronize()
    _launched(before, "ht", 1)
    assert torch.equal(got, fused_ht.xsect_ht(dp, lay, s, w, consts,
                                              fast=True))
    _fast_check("K5", got, fused_ht.xsect_ht(dp, lay, s, w, consts),
                fused_ht.xsect_ht_plain(dp, lay, s, w, consts, fast=True),
                2e-6)
    with pytest.raises(ValueError, match="FAST"):
        _build.entry("radtxfr_fused_ht_jvp", fast=True)
    before = Counter(fused_xsect.LAUNCHES)
    v = (torch.randn(s.shape, device=dev) * s.abs().mean()).contiguous()
    val, _ = torch.func.jvp(lambda x: fused_ht.xsect_ht_diff(
        dp, lay, x, w, consts, fast=True), (s,), (v,))
    torch.cuda.synchronize()
    assert torch.equal(val, got)
    _launched(before, "ht", 1)
    assert fused_xsect.LAUNCHES["ht_jvp"] == before["ht_jvp"] + 1


def test_fast_launch_failure_raises(dev, monkeypatch):
    """A FAST launch that returns a CUDA error raises, counts nothing and
    never runs the IEEE instantiation or the plain version in its place."""
    from radtxfr_tpu_torch import _build

    dp, lay, prm = _random_case(dev, n_pts=4000)
    g2 = prm.pop("gamma_2")
    asked = []

    def failing(name, fast=False):
        asked.append((name, fast))
        return lambda *a: 700     # cudaErrorIllegalAddress

    monkeypatch.setattr(_build, "entry", failing)
    before = Counter(fused_xsect.LAUNCHES)
    with pytest.raises(RuntimeError, match="fast=True"):
        fused_xsect.xsect_fused(dp, lay, *prm.values(), None, "sdvoigt",
                                gamma_2=g2, fast=True)
    assert asked == [("radtxfr_fused_xsect", True)]
    assert Counter(fused_xsect.LAUNCHES) == before
