"""The port's public entry points on NumPy arrays, against radtxfr_tpu.

JAX's public functions take any array ``jnp`` takes, NumPy arrays
included; so does every public entry point of the port whose JAX
counterpart takes an array. Each case feeds the same seeded NumPy inputs
to the JAX function (CPU, x64) and to its counterpart in the port and
holds the results together: float64 within 1e-12 of each output's peak;
the float32 kernel routes within the package's float32 bounds (line OD
2e-6 of peak, the K2 composition 6e-7). A float result keeps JAX's dtype
(a NumPy float64 array stays float64 where the route computes in its
input's dtype; the kernel builders cast to their store's dtype, as the
tensor route does).

The input rule: a NumPy argument goes to the device of the call's own
tensors (the builder's store or plan, ``params``, the operator's weights,
a tensor argument); a call whose arrays are all NumPy runs on the card,
or on ``device=`` where the function takes one. So each such case also
calls the port without ``device=`` and expects "no CUDA device" here:
nothing falls back to the CPU. Where the port draws its own random numbers
(a ``torch.Generator`` for JAX's key), and where JAX's reference would
take seconds to compile and another port test (named in the case) already
holds the tensor route against it, the NumPy call is held bit for bit to
the same call on tensors. JAX functions that dispatch op by op are called
under ``jax.jit`` (``jitted``): the same arithmetic, compiled once.

``test_every_array_entry_point_is_swept`` holds the sweep complete: every
public callable of each JAX module (and each public method of its
classes, with the builders' returned callables) that takes a parameter is
a case here or is listed in ``NO_ARRAY_CASE`` with its reason.
"""

import dataclasses
import importlib
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radtxfr_tpu.atmos.continuum as j_cont
import radtxfr_tpu.atmos.far_wing as j_far
import radtxfr_tpu.atmos.regrid as j_regrid
import radtxfr_tpu.compat as j_compat
import radtxfr_tpu.core.planck as j_planck
import radtxfr_tpu.core.reshape as j_reshape
import radtxfr_tpu.dist.checkpoint as j_ckpt
import radtxfr_tpu.dist.mesh as j_mesh
import radtxfr_tpu.io.afit_xs as j_afit
import radtxfr_tpu.io.envi as j_envi
import radtxfr_tpu.io.h5 as j_h5
import radtxfr_tpu.io.lblrtm as j_lblrtm
import radtxfr_tpu.io.mbi as j_mbi
import radtxfr_tpu.kernels.faddeeva as j_fad
import radtxfr_tpu.kernels.ht_driver as j_htd
import radtxfr_tpu.kernels.htp_real as j_htr
import radtxfr_tpu.kernels.linemixing as j_mix
import radtxfr_tpu.kernels.linemixing_data as j_mixd
import radtxfr_tpu.kernels.lineparams as j_lp
import radtxfr_tpu.kernels.pallas_xsect as j_px
import radtxfr_tpu.kernels.profiles as j_prof
import radtxfr_tpu.kernels.spectra as j_spec
import radtxfr_tpu.kernels.xsect as j_xsect
import radtxfr_tpu.lines.query as j_query
import radtxfr_tpu.lines.store as j_store_mod
import radtxfr_tpu.lines.tips as j_tips
import radtxfr_tpu.products.od as j_od
import radtxfr_tpu.products.radiance as j_rad
import radtxfr_tpu.products.tud as j_tud
import radtxfr_tpu.scene.emis_features as j_feat
import radtxfr_tpu.scene.emissivity as j_emis
import radtxfr_tpu.scene.generative as j_gen
import radtxfr_tpu.scene.planck_fit as j_pfit
import radtxfr_tpu.scene.robust as j_robust
import radtxfr_tpu.sensor.ils as j_ils
import radtxfr_tpu.sensor.resolution as j_res
import radtxfr_tpu.utils.profiling as j_profiling
from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
from radtxfr_tpu.atmos.profile import AtmosphericState as JState
from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic

from radtxfr_tpu_torch import as_numpy
from radtxfr_tpu_torch import compat
from radtxfr_tpu_torch.atmos import continuum, far_wing, regrid
from radtxfr_tpu_torch.atmos.profile import AtmosphericState, std_atmosphere
from radtxfr_tpu_torch.core import planck, reshape
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.dist import checkpoint, fused_ensemble
from radtxfr_tpu_torch.dist import mesh as mesh_mod
from radtxfr_tpu_torch.dist.ensemble import tud_ensemble_sharded
from radtxfr_tpu_torch.io import afit_xs, envi, h5, lblrtm, mbi
from radtxfr_tpu_torch.kernels import (faddeeva, fused_xsect, ht_driver, htp,
                                       htp_real, linemixing, linemixing_data,
                                       lineparams, profiles, spectra, xsect)
from radtxfr_tpu_torch.lines import query
from radtxfr_tpu_torch.lines import store as store_mod
from radtxfr_tpu_torch.lines import tips
from radtxfr_tpu_torch.lines.store import IsoTables
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
from radtxfr_tpu_torch.products import jacobian, od, radiance
from radtxfr_tpu_torch.products import tud
from radtxfr_tpu_torch.products.od_sharded_lines import \
    make_od_sharded_lines_fn
from radtxfr_tpu_torch.scene import (emis_features, emissivity, generative,
                                     hsi, planck_fit, robust)
from radtxfr_tpu_torch.sensor import ils, resolution
from radtxfr_tpu_torch.utils import profiling
from port_fixtures import one_torch_thread  # noqa: F401

# the modules, which the subpackages' function of the same name shadows
j_xs = importlib.import_module("radtxfr_tpu.products.od_from_xs")
od_from_xs = importlib.import_module("radtxfr_tpu_torch.products.od_from_xs")

CPU = dict(device="cpu")
F64 = dict(device="cpu", dtype=torch.float64)
#: float64 agreement with JAX on the same NumPy inputs, of peak
REL = 1e-12
#: the float32 kernel routes against JAX's Pallas ones, of peak
OD_BOUND = 2e-6
COMP_BOUND = 6e-7

#: the Hartmann-Tran routes against JAX's (``tests/test_torch_ht.py``)
HT_BOUND = 5e-5

#: the small band of the line cases: about 50 lines, 805-806 cm^-1
BAND = (805.0, 806.0, 0.005)
N_LINES = 50


# ---------------------------------------------------------------------------
# comparison helpers
# ---------------------------------------------------------------------------

def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (jax.Array, np.ndarray, np.generic)):
        return [np.asarray(x)]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return [v for f in dataclasses.fields(x)
                for v in _leaves(getattr(x, f.name))]
    if isinstance(x, dict):
        return [v for k in sorted(x, key=str) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for e in x for v in _leaves(e)]
    return [x]


def check(got, want, bound=REL, dtypes=True, device="cpu"):
    """``got`` (the port's) against ``want`` (JAX's) leaf by leaf: every
    tensor on ``device``; arrays of one shape (and, with ``dtypes``, one
    float dtype), integers and booleans equal, floats within ``bound`` of
    the leaf's peak with NaN where JAX has NaN; other leaves equal."""
    g, w = _leaves(got), _leaves(want)
    assert len(g) == len(w), (len(g), len(w))
    for a, b in zip(g, w):
        if isinstance(a, torch.Tensor):
            assert a.device.type == device, a.device
            a = as_numpy(a)
        if not isinstance(b, np.ndarray):
            assert not isinstance(a, np.ndarray) or a.ndim == 0, type(a)
            assert a == b or (a != a and b != b), (a, b)
            continue
        a = np.asarray(a)
        assert a.shape == b.shape, (a.shape, b.shape)
        if dtypes and b.dtype.kind in "fc":
            assert a.dtype == b.dtype, (a.dtype, b.dtype)
        if b.dtype.kind not in "fc":
            np.testing.assert_array_equal(a, b)
            continue
        nan = np.isnan(b)
        np.testing.assert_array_equal(np.isnan(a), nan)
        if nan.all():
            continue
        peak = max(np.abs(b[~nan]).max(), 1e-300)
        err = np.abs(a[~nan].astype(b.dtype) - b[~nan]).max() / peak
        assert err <= bound, err


def same_bits(a, b):
    """Leaf by leaf the same dtype, shape and bytes."""
    ga, gb = _leaves(a), _leaves(b)
    assert len(ga) == len(gb)
    for x, y in zip(ga, gb):
        x = as_numpy(x) if isinstance(x, torch.Tensor) else x
        y = as_numpy(y) if isinstance(y, torch.Tensor) else y
        if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()
        else:
            assert x == y or (x != x and y != y)


def needs_card(fn, *args, **kw):
    """An all-NumPy call without ``device=`` runs on the card: it raises
    where there is none."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            fn(*args, **kw)


def jitted(j_fn, *args, **kw):
    """JAX's ``j_fn`` called once under ``jax.jit`` with its NumPy arrays
    (nested in lists and tuples too) traced and everything else closed
    over: its eager op-by-op dispatch compiles every small op apart, which
    takes several times as long here."""
    leaves, tree = jax.tree_util.tree_flatten((args, kw))
    arr = [i for i, v in enumerate(leaves) if isinstance(v, np.ndarray)]

    def call(vals):
        full = list(leaves)
        for i, v in zip(arr, vals):
            full[i] = v
        a, k = jax.tree_util.tree_unflatten(tree, full)
        return j_fn(*a, **k)

    return jax.jit(call)([leaves[i] for i in arr])


def pair(j_fn, fn, *args, bound=REL, dtypes=True, card=True, pkw=None,
         jit=False, **kw):
    """JAX's ``j_fn`` (under ``jax.jit`` with ``jit``) and the port's
    ``fn`` on the same NumPy arguments (the port's with ``pkw``, default
    ``device="cpu"`` where ``card``); with ``card``, the port's call
    without ``device=`` needs the card."""
    pkw = (CPU if card else {}) if pkw is None else pkw
    want = jitted(j_fn, *args, **kw) if jit else j_fn(*args, **kw)
    got = fn(*args, **kw, **pkw)
    check(got, want, bound, dtypes)
    if card:
        needs_card(fn, *args, **kw)
    return got


def t(a):
    return torch.as_tensor(np.asarray(a))


def like_tensors(fn, *args, card=True, **kw):
    """``fn`` on NumPy arguments gives the bits of ``fn`` on the same
    arguments as CPU tensors, the route the port's other tests hold
    against JAX; with ``card``, the all-NumPy call without ``device=``
    needs the card."""
    tens = lambda a: t(a) if isinstance(a, np.ndarray) else a  # noqa: E731
    got = fn(*args, **kw, **(CPU if card else {}))
    same_bits(got, fn(*map(tens, args), **{k: tens(v) for k, v in kw.items()}))
    if card:
        needs_card(fn, *args, **kw)
    return got


def _cpu_gen(seed=0):
    g = torch.Generator(device="cpu")
    g.manual_seed(seed)
    return g


# ---------------------------------------------------------------------------
# shared inputs
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def small():
    """About 50 synthetic lines around 805-806 cm^-1 (a third with speed
    dependence), the 66-layer standard atmosphere (NumPy columns too) and
    the float64 isotopologue tables, in both packages."""
    kw = dict(nu_min=BAND[0] - 1.0, nu_max=BAND[1] + 1.0, seed=3,
              sd_zero_frac=0.3)
    j_atm = j_std_atmosphere()
    cols = {f: np.asarray(getattr(j_atm, f))
            for f in ("z0", "z1", "pl", "p", "T", "vmr")}
    idx = np.array([0, 20, 40, 60])
    cols4 = {f: v[idx] for f, v in cols.items()}
    return dict(j_store=j_synthetic(N_LINES, **kw),
                store=synthetic_lines(N_LINES, **kw, **F64),
                j_atm=j_atm, atm=std_atmosphere(**F64), cols=cols,
                iso=IsoTables.load(**F64),
                axis=arange_drift_free(*BAND), cols4=cols4,
                j_atm4=JState(**{f: jnp.asarray(v) for f, v in cols4.items()}),
                atm4=AtmosphericState.from_numpy(**cols4, **F64))


def _spectrum(n=801, lo=700.0, hi=1300.0, cols=2, seed=0):
    rng = np.random.default_rng(seed)
    X = np.linspace(lo, hi, n)
    Y = (1.0 + 0.5 * np.sin(X[:, None] / (3.0 + np.arange(cols)))
         + 0.1 * rng.random((n, cols)))
    return X, Y


def _line_params_np(n=40, seed=5):
    """(L,) NumPy LineParams fields on 805-806 cm^-1."""
    rng = np.random.default_rng(seed)
    nu0 = np.sort(rng.uniform(BAND[0] - 0.5, BAND[1] + 0.5, n))
    return dict(nu0=nu0, nu0_shifted=nu0 + rng.uniform(-1e-3, 1e-3, n),
                strength=rng.uniform(1e-22, 1e-20, n),
                gamma_d=rng.uniform(8e-4, 1.2e-3, n),
                gamma_0=rng.uniform(0.02, 0.08, n),
                wing=np.full(n, 2.0), gamma_2=rng.uniform(0.0, 0.01, n),
                shift0=rng.uniform(-1e-3, 1e-3, n))


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

CASES = {}


def case(*names):
    """Register a case covering ``names`` ("module.py::qualified name",
    paths relative to the JAX package, the port's renames applied)."""
    def deco(fn):
        CASES[fn.__name__[len("case_"):]] = (names, fn)
        return fn
    return deco


# --- the sites the sweep repaired (Motivation's table first) --------------

@case("products/tud.py::tud_from_od")
def case_tud_from_od(small):
    rng = np.random.default_rng(1)
    X = np.linspace(800.0, 900.0, 64)
    od_ = 0.05 * rng.random((12, 64))
    T = 220.0 + 80.0 * rng.random(12)
    B = np.asarray(j_planck.planckian(X, T)).T
    z0 = np.linspace(0.0, 30.0, 12)
    alts = np.array([0.5, 7.0, 500.0])
    mu = np.array([1.0, 1.3])
    pair(j_tud.tud_from_od, tud.tud_from_od, X, od_, B, z0, alts, mu=mu,
         n_angles=6)
    # a tensor od keeps the call on its device; NumPy B, z0 and mu join it
    same_bits(tud.tud_from_od(X, t(od_), B, z0, alts, mu=mu, n_angles=6),
              tud.tud_from_od(X, t(od_), t(B), t(z0), t(alts), mu=t(mu),
                              n_angles=6))


@case("sensor/resolution.py::smooth", "compat.py::smooth")
def case_smooth():
    X, Y = _spectrum()
    for w in ("hanning", "flat", "blackman"):
        pair(j_res.smooth, resolution.smooth, Y[:, 0], 21, w)
    pair(j_compat.smooth, compat.smooth, Y[:, 1], 11)


@case("sensor/resolution.py::reduce_resolution")
def case_reduce_resolution():
    X, Y = _spectrum()
    pair(j_res.reduce_resolution, resolution.reduce_resolution, X, Y[:, 0],
         2.0)
    pair(j_res.reduce_resolution, resolution.reduce_resolution, X, Y, 2.0)
    got = resolution.reduce_resolution(X, Y, 2.0, X_out=X[100:700:7], **CPU)
    check(got, j_res.reduce_resolution(X, Y, 2.0, X_out=X[100:700:7]))
    same_bits(resolution.reduce_resolution(X, t(Y), 2.0),
              resolution.reduce_resolution(t(X), t(Y), 2.0))


@case("sensor/resolution.py::apply_resample",
      "sensor/resolution.py::cubic_resample_weights")
def case_apply_resample():
    X, Y = _spectrum()
    x_out = np.linspace(710.0, 1290.0, 97)
    idx, w = pair(j_res.cubic_resample_weights,
                  resolution.cubic_resample_weights, X, x_out, card=False)
    pair(j_res.apply_resample, resolution.apply_resample, idx, w, Y)
    same_bits(resolution.apply_resample(idx, w, t(Y)),
              resolution.apply_resample(t(idx), t(w), t(Y)))


@case("sensor/resolution.py::ReduceOperator",
      "sensor/resolution.py::ReduceOperator.__call__",
      "sensor/resolution.py::reduce_operator")
def case_reduce_operator():
    X, Y = _spectrum()
    j_op = j_res.reduce_operator(X, 2.0)
    op = resolution.reduce_operator(X, 2.0, **CPU)
    check(op.x_out, j_op.x_out)
    check(op(Y), j_op(Y))
    check(op(Y[:, 0]), j_op(Y[:, 0]))
    same_bits(op(Y), op(t(Y)))
    # the operator from its NumPy stencil, and the non-affine route
    op2 = resolution.ReduceOperator(op.x_out, as_numpy(op.starts),
                                    as_numpy(op.weights), **CPU)
    j_op2 = j_res.ReduceOperator(np.asarray(j_op.x_out),
                                 np.asarray(j_op.starts),
                                 np.asarray(j_op.weights))
    check(op2(Y), j_op2(Y))
    needs_card(resolution.ReduceOperator, op.x_out, as_numpy(op.starts),
               as_numpy(op.weights))
    jag = resolution.reduce_operator(X, 2.0, X_out=np.sort(
        np.random.default_rng(2).uniform(720.0, 1280.0, 40)), **CPU)
    assert jag._affine is None
    same_bits(jag(Y), jag(t(Y)))


@case("kernels/xsect.py::xsect_from_params", "kernels/xsect.py::pad_params")
def case_xsect_from_params():
    axis = arange_drift_free(*BAND)
    f = _line_params_np()
    j_p = j_lp.LineParams(**{k: jnp.asarray(v) for k, v in f.items()})
    p = lineparams.LineParams(**{k: t(v) for k, v in f.items()})
    for prof in ("voigt", "lorentz", "doppler", "sdvoigt"):
        got = xsect.xsect_from_params(axis, p, profile=prof)
        if prof == "voigt":
            check(got, j_xsect.xsect_from_params(axis, j_p, profile=prof))
        same_bits(got, xsect.xsect_from_params(t(axis), p, profile=prof))
    same_bits(xsect.xsect_from_params(axis, xsect.pad_params(p, 64)),
              xsect.xsect_from_params(axis, p))


@case("kernels/linemixing.py::xsect_voigt_mixing",
      "kernels/linemixing.py::mixing_coefficient")
def case_xsect_voigt_mixing():
    axis = arange_drift_free(*BAND)
    f = _line_params_np()
    j_p = j_lp.LineParams(**{k: jnp.asarray(v) for k, v in f.items()})
    p = lineparams.LineParams(**{k: t(v) for k, v in f.items()})
    rng = np.random.default_rng(4)
    y_air = rng.uniform(-0.02, 0.02, 40)
    y_self = rng.uniform(-0.03, 0.03, 40)
    Y = pair(j_mix.mixing_coefficient, linemixing.mixing_coefficient, y_air,
             np.array(0.7), np.array(250.0), y_self=y_self,
             x_self=np.array(0.01), n_T=0.7)
    got = linemixing.xsect_voigt_mixing(axis, p, as_numpy(Y))
    check(got, j_mix.xsect_voigt_mixing(axis, j_p, np.asarray(Y)))
    same_bits(got, linemixing.xsect_voigt_mixing(t(axis), p, Y))


@case("products/od.py::make_od_pallas_fn",
      "products/od.py::OpticalDepthFn.__call__")
def case_make_od_fn(small):
    s = small
    j_fn = j_od.make_od_pallas_fn(s["j_store"], j_store_mod.IsoTables.load(),
                                  s["axis"], s["j_atm"])
    fn = od.make_od_fn(s["store"], s["iso"], s["axis"], s["atm"])
    c = s["cols"]
    got = fn(c["T"], c["p"], c["pl"], c["vmr"])
    check(got, j_fn(c["T"], c["p"], c["pl"], c["vmr"]), OD_BOUND,
          dtypes=False)
    atm = s["atm"]
    same_bits(got, fn(atm.T, atm.p, atm.pl, atm.vmr))
    assert got.dtype == s["store"].sw.dtype


@case("products/od.py::make_od_ht_pallas_fn",
      "products/od.py::HTOpticalDepthFn.__call__")
def case_make_od_ht_fn(small):
    s = small
    rng = np.random.default_rng(7)
    on = np.arange(N_LINES) < N_LINES // 3
    extras = {"nu_HT_air": rng.uniform(0.01, 0.05, N_LINES) * on,
              "eta_HT_air": rng.uniform(0.1, 0.3, N_LINES) * on}
    c, atm = s["cols4"], s["atm4"]
    fn = od.make_od_ht_fn(s["store"], s["iso"], s["axis"], atm,
                          extras=extras, tile=128)
    # the tensor route is held against make_od_ht_pallas_fn in
    # tests/test_torch_ht.py (its interpret-mode kernels take 15 s here)
    got = fn(c["T"], c["p"], c["pl"], c["vmr"])
    same_bits(got, fn(atm.T, atm.p, atm.pl, atm.vmr))
    assert got.dtype == s["store"].sw.dtype


@case("products/od.py::make_xsect_pallas_fn",
      "products/od.py::CrossSectionFn.__call__")
def case_make_xsect_fn(small):
    s = small
    T, p = np.array([240.0, 296.0]), np.array([0.5, 1.0])
    j_fn = j_od.make_xsect_pallas_fn(s["j_store"],
                                     j_store_mod.IsoTables.load(), s["axis"],
                                     T, p)
    fn = od.make_xsect_fn(s["store"], s["iso"], s["axis"], T, p)
    got = fn(T, p)
    check(got, j_fn(T, p), OD_BOUND, dtypes=False)
    same_bits(got, fn(t(T), t(p)))


@case("products/od.py::make_ht_pallas_fn",
      "products/od.py::HTCrossSectionFn.__call__")
def case_make_ht_fn(small):
    s = small
    T, p = np.array([240.0, 296.0]), np.array([0.5, 1.0])
    extras = {"eta_HT_air": np.full(N_LINES, 0.2)}
    fn = od.make_ht_fn(s["store"], s["iso"], s["axis"], T, p, extras=extras)
    # the tensor route is held against make_ht_pallas_fn in
    # tests/test_torch_ht.py
    same_bits(fn(T, p), fn(t(T), t(p)))


# --- the layered OD's library surface -------------------------------------

@case("kernels/lineparams.py::compute_line_params")
def case_compute_line_params(small):
    s = small
    rng = np.random.default_rng(8)
    # one state, as JAX's (the builders vmap it over layers)
    T, p = np.array(255.0), np.array(0.6)
    x = rng.uniform(0.0, 0.02, N_LINES)
    scale = rng.uniform(1e20, 1e22, N_LINES)
    for prof in ("voigt", "sdvoigt"):
        kw = dict(vmr_self=x, strength_scale=scale, profile=prof,
                  abundance_ratio=np.full(N_LINES, 0.98))
        got = lineparams.compute_line_params(s["store"], s["iso"], T, p, **kw)
        if prof == "voigt":
            check(got, jitted(j_lp.compute_line_params, s["j_store"],
                              j_store_mod.IsoTables.load(), T, p, **kw))
        same_bits(got, lineparams.compute_line_params(
            s["store"], s["iso"], t(T), t(p), **{
                k: (t(v) if isinstance(v, np.ndarray) else v)
                for k, v in kw.items()}))


@case("products/od.py::species_column", "products/od.py::compute_od_layer",
      "products/od.py::layer_line_params", "products/od.py::compute_od_layers")
def case_od_layers(small):
    s, c = small, small["cols"]
    pair(j_od.species_column, od.species_column, c["p"][:, None],
         c["T"][:, None], c["pl"][:, None], c["vmr"], jit=True)
    iso_j = j_store_mod.IsoTables.load()
    cols = np.asarray(j_od._line_species_cols(s["j_store"],
                                              s["j_atm"].mol_ids))
    lay = (c["T"][3], c["p"][3], c["pl"][3], c["vmr"][3])
    got = od.compute_od_layer(s["store"], s["iso"], s["axis"], *lay, cols)
    check(got, jitted(j_od.compute_od_layer, s["j_store"], iso_j,
                      s["axis"], *lay, cols))
    same_bits(od.layer_line_params(s["store"], s["iso"], s["atm4"], cols),
              od.layer_line_params(s["store"], s["iso"], s["atm4"], t(cols)))
    # compute_od_layers' tensor route: tests/test_torch_od_layers.py
    same_bits(od.compute_od_layers(s["store"], s["iso"], s["axis"],
                                   s["atm4"]),
              od.compute_od_layers(s["store"], s["iso"], t(s["axis"]),
                                   s["atm4"]))


@case("products/od.py::make_od_plan", "products/od.py::group_by_wing",
      "products/od.py::group_layers_by_wing",
      "products/od.py::ht_wing_bounds")
def case_od_planning(small):
    s = small
    iso_j = j_store_mod.IsoTables.load()
    plan = od.make_od_plan(s["store"], s["iso"], s["axis"], s["atm"],
                           tile=256, block=32)
    j_plan = j_od.make_od_plan(s["j_store"], iso_j, s["axis"], s["j_atm"],
                               tile=256, block=32)
    for f in ("starts", "counts", "k_line", "frac0"):
        np.testing.assert_array_equal(getattr(plan, f), getattr(j_plan, f))
    wings = np.random.default_rng(9).uniform(0.1, 10.0, 30)
    for fn, j_fn in ((od.group_by_wing, j_od.group_by_wing),
                     (od.group_layers_by_wing, j_od.group_layers_by_wing)):
        check(fn(wings), j_fn(wings))
    T, p = np.array([220.0, 260.0, 300.0]), np.array([0.1, 0.5, 1.0])
    extras = {"eta_HT_air": np.full(N_LINES, 0.2)}
    air = {"air": 1.0}
    resolved = ht_driver.resolve_ht_columns(s["store"], extras, air)
    j_resolved = j_htd.resolve_ht_columns(s["j_store"], extras, air)
    check(od.ht_wing_bounds(resolved, s["store"], s["iso"], T, p),
          j_od.ht_wing_bounds(j_resolved, s["j_store"].host_view(), iso_j,
                              T, p))


@case("kernels/ht_driver.py::xsect_ht",
      "kernels/ht_driver.py::resolve_ht_columns",
      "kernels/ht_driver.py::ht_params",
      "kernels/ht_driver.py::ht_xsect_from_params")
def case_ht_driver(small):
    s = small
    iso_j = j_store_mod.IsoTables.load()
    rng = np.random.default_rng(10)
    extras = {"eta_HT_air": rng.uniform(0.0, 0.3, N_LINES),
              "nu_HT_air": rng.uniform(0.0, 0.05, N_LINES)}
    diluent = {"air": 0.8, "self": 0.2}
    T, p = np.array(260.0), np.array(0.6)
    got = ht_driver.xsect_ht(s["axis"], s["store"], s["iso"], T, p,
                             diluent=diluent, extras=extras)
    check(got, j_htd.xsect_ht(s["axis"], s["j_store"], iso_j, T, p,
                              diluent=diluent, extras=extras))
    res = ht_driver.resolve_ht_columns(s["store"], extras, diluent)
    abun = [np.array(0.7), np.array(0.3)]
    # ht_params' tensor route: tests/test_torch_ht.py
    prm = ht_driver.ht_params(res, s["store"], s["iso"], T, p, abun=abun,
                              complex_dtype=torch.complex128)
    same_bits(prm, ht_driver.ht_params(res, s["store"], s["iso"], t(T),
                                       t(p), abun=[t(a) for a in abun],
                                       complex_dtype=torch.complex128))
    # its tensor route: tests/test_torch_jnp_engine.py (through xsect_ht)
    same_bits(ht_driver.ht_xsect_from_params(s["axis"],
                                             s["store"].host["nu0"], prm),
              ht_driver.ht_xsect_from_params(t(s["axis"]), s["store"].nu0,
                                             prm))


@case("products/od.py::make_od_pallas_local_fn",
      "products/od.py::LocalOpticalDepthFn.__call__",
      "products/od.py::ShardOD.__call__")
def case_make_od_local_fn(small):
    s = small
    c = s["cols"]
    fn, spec, gpad = od.make_od_local_fn(s["store"], s["iso"], s["axis"],
                                         s["atm"], 2, partition="equal")
    atm = s["atm"]
    for k in range(2):
        got = fn(c["T"], c["p"], c["pl"], c["vmr"], spec[k],
                 k * fn.n_local)
        same_bits(got, fn.bind(spec[k], k * fn.n_local)(
            atm.T, atm.p, atm.pl, atm.vmr))


@case("products/od_sharded_lines.py::make_od_sharded_lines_fn")
def case_make_od_sharded_lines_fn(small):
    s = small
    c = s["cols"]
    local_fn, data, gpad = make_od_sharded_lines_fn(
        s["store"], s["iso"], s["axis"], s["atm"], 2)
    for k in range(2):
        sl = od.shard_slice(data, k)
        got = local_fn(c["T"], c["p"], c["pl"], c["vmr"], sl,
                       k * (gpad.n // 2))
        atm = s["atm"]
        same_bits(got, local_fn(atm.T, atm.p, atm.pl, atm.vmr, sl,
                                k * (gpad.n // 2)))


@case("products/od_from_xs.py::build_xs_table",
      "products/od_from_xs.py::od_from_xs",
      "products/od_from_xs.py::interp_sigma")
def case_od_from_xs(small):
    s = small
    T_grid = np.array([200.0, 300.0])
    p_grid = np.array([0.01, 1.0])
    # the tensor routes: tests/test_torch_od_from_xs.py (the port's table
    # is float32 on every device, its serving dtype)
    table = od_from_xs.build_xs_table(s["store"], s["iso"], s["axis"],
                                      T_grid, p_grid)
    same_bits(table.sigma, od_from_xs.build_xs_table(
        s["store"], s["iso"], t(s["axis"]), t(T_grid), t(p_grid)).sigma)
    for T, p in ((np.array(230.0), np.array(0.05)),
                 (np.array(280.0), np.array(0.7))):
        same_bits(od_from_xs.interp_sigma(table, T, p),
                  od_from_xs.interp_sigma(table, t(T), t(p)))
    od_ = od_from_xs.od_from_xs(table, s["atm4"])
    assert od_.shape == (4, s["axis"].size)


@case("products/jacobian.py::tud_with_jacobian")
def case_tud_with_jacobian(small):
    s = small
    alts = np.array([1.0, 500.0])
    kw = dict(wrt=("T",), n_angles=4)
    # the tensor route: tests/test_torch_jnp_engine.py
    got = jacobian.tud_with_jacobian(s["store"], s["iso"], s["axis"],
                                     s["atm4"], alts, **kw)
    same_bits(got, jacobian.tud_with_jacobian(
        s["store"], s["iso"], t(s["axis"]), s["atm4"], t(alts), **kw))


@case("products/tud.py::make_tud_pallas_fn")
def case_make_tud_fn():
    rng = np.random.default_rng(11)
    n_lay, n_x = 8, 256
    z0 = np.linspace(0.0, 40.0, n_lay)
    alts, mu = np.array([0.5, 6.0, 500.0]), np.array([1.0, 1.4])
    T = (230.0 + 60.0 * rng.random(n_lay)).astype(np.float32)
    od_ = (0.2 * rng.random((n_lay, n_x))).astype(np.float32)
    x = np.linspace(800.0, 900.0, n_x)
    fn = tud.make_tud_fn(z0, alts, mu=mu, n_angles=6, **CPU)
    got = fn(x, od_, T)
    want = j_tud.make_tud_pallas_fn(z0, alts, mu=mu, n_angles=6)(x, od_, T)
    check(got, want, COMP_BOUND, dtypes=False)
    same_bits(got.tau, fn(t(x), t(od_), t(T)).tau)
    needs_card(tud.make_tud_fn, z0, alts)


@case("products/radiance.py::apparent_radiance",
      "compat.py::compute_LWIR_apparent_radiance")
def case_apparent_radiance():
    rng = np.random.default_rng(12)
    nX, nE, nA = 60, 3, 2
    X = np.linspace(800.0, 1200.0, nX)
    em = rng.uniform(0.8, 1.0, (nX, nE))
    Ts = rng.uniform(270.0, 310.0, nA)
    tau, Lu, Ld = (rng.uniform(0.1, 1.0, (nX, nA)) for _ in range(3))
    pair(j_rad.apparent_radiance, radiance.apparent_radiance, X, em, Ts, tau,
         Lu, Ld)
    # the tensor routes: tests/test_torch_scene.py, test_torch_compat.py
    like_tensors(radiance.apparent_radiance, X, em, Ts, tau, Lu, Ld,
                 dT=np.array([-1.0, 0.0, 2.0]), return_Ls=True)
    like_tensors(compat.compute_LWIR_apparent_radiance, X, em, Ts, tau, Lu,
                 Ld)


# --- core, compat ---------------------------------------------------------

@case("core/planck.py::planckian", "core/planck.py::brightness_temperature",
      "core/planck.py::bt2l", "compat.py::planckian",
      "compat.py::brightnessTemperature", "compat.py::BT2L")
def case_planck():
    rng = np.random.default_rng(13)
    X = np.linspace(700.0, 1400.0, 40)
    T = rng.uniform(200.0, 320.0, 3)
    L = pair(j_planck.planckian, planck.planckian, X, T)
    pair(j_planck.brightness_temperature, planck.brightness_temperature, X,
         as_numpy(L))
    # the tensor routes: tests/test_torch_scene.py, test_torch_compat.py
    like_tensors(planck.bt2l, X, rng.uniform(200.0, 320.0, (40, 2)))
    like_tensors(planck.planckian, np.linspace(7.5, 13.5, 40), T,
                 wavelength=True)
    like_tensors(compat.planckian, X, T)
    like_tensors(compat.brightnessTemperature, X, as_numpy(L))
    like_tensors(compat.BT2L, X, rng.uniform(200.0, 320.0, (2, 40)),
                 spectral_dim=1)


@case("core/reshape.py::rs1d", "core/reshape.py::rs2d",
      "core/reshape.py::rsnd", "compat.py::rs1D", "compat.py::rs2D",
      "compat.py::rsND")
def case_reshape():
    y = np.random.default_rng(14).random((5, 3, 4))
    for j_fn, fn in ((j_reshape.rs1d, reshape.rs1d),
                     (j_reshape.rs2d, reshape.rs2d),
                     (j_compat.rs1D, compat.rs1D),
                     (j_compat.rs2D, compat.rs2D)):
        pair(j_fn, fn, y)
        pair(j_fn, fn, y[:, 0, 0])
    pair(j_reshape.rsnd, reshape.rsnd, y.reshape(5, 12), (5, 3, 4))
    pair(j_compat.rsND, compat.rsND, y.reshape(5, 12), (5, 3, 4))


@case("compat.py::ILS_MAKO", "compat.py::reduceResolution")
def case_compat_sensor():
    X, Y = _spectrum(2401, 700.0, 1340.0)
    pair(j_compat.ILS_MAKO, compat.ILS_MAKO, X, Y)
    pair(j_compat.reduceResolution, compat.reduceResolution, X, Y, 1.0)


# --- sensor ---------------------------------------------------------------

@case("sensor/ils.py::ils_mako", "sensor/ils.py::ils_mako_simple",
      "sensor/ils.py::apply_ils", "sensor/ils.py::ils_matrix",
      "sensor/ils.py::mako_axis_wn")
def case_ils():
    X, Y = _spectrum(2401, 700.0, 1340.0)
    pair(j_ils.ils_mako, ils.ils_mako, X, Y)
    pair(j_ils.ils_mako_simple, ils.ils_mako_simple, X, Y)
    centers = pair(j_ils.mako_axis_wn, ils.mako_axis_wn, X, card=False)
    W = pair(j_ils.ils_matrix, ils.ils_matrix, X, centers,
             np.full(centers.size, 4.0), card=False)
    pair(j_ils.apply_ils, ils.apply_ils, W, Y)


# --- kernels: profiles, CPFs, spectra, tips --------------------------------

def _plane(n=400, seed=15):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-30.0, 30.0, n), 10.0 ** rng.uniform(-4.0, 1.5, n))


@case("kernels/faddeeva.py::wofz_real", "kernels/faddeeva.py::cpf3",
      "kernels/faddeeva.py::cpf_humlicek", "kernels/faddeeva.py::cef",
      "kernels/faddeeva.py::wofz_real_series_only")
def case_faddeeva():
    x, y = _plane()
    for name in ("wofz_real", "cpf_humlicek"):
        pair(getattr(j_fad, name), getattr(faddeeva, name), x, y, jit=True)
    # the other CPFs' tensor routes: tests/test_torch_jnp_engine.py
    for name in ("cpf3", "cef", "wofz_real_series_only"):
        like_tensors(getattr(faddeeva, name), x, y)


@case("kernels/profiles.py::voigt", "kernels/profiles.py::lorentz",
      "kernels/profiles.py::doppler")
def case_profiles():
    rng = np.random.default_rng(16)
    dnu = np.linspace(-2.0, 2.0, 201)
    gd, g0 = rng.uniform(1e-3, 3e-3, 201), rng.uniform(0.01, 0.1, 201)
    pair(j_prof.voigt, profiles.voigt, dnu, gd, g0, jit=True)
    pair(j_prof.lorentz, profiles.lorentz, dnu, g0, jit=True)
    pair(j_prof.doppler, profiles.doppler, dnu, gd, jit=True)


HTP_ARGS = dict(sg0=np.array(1000.0), gamma_d=np.array(0.0012),
                gamma0=np.array(0.07), gamma2=np.array(0.007),
                shift0=np.array(-0.002), shift2=np.array(1e-4),
                anuvc=np.array(0.02), eta=np.array(0.15))


@case("kernels/htp.py::pcqsdhc", "kernels/htp.py::profile_ht",
      "kernels/htp.py::profile_sdvoigt", "kernels/htp.py::profile_sdrautian",
      "kernels/htp.py::profile_rautian")
def case_htp():
    a = HTP_ARGS
    sg = np.linspace(999.0, 1001.0, 301)
    full = [a[k] for k in ("sg0", "gamma_d", "gamma0", "gamma2", "shift0",
                           "shift2", "anuvc", "eta")]
    # the tensor routes, against JAX's in tests/test_torch_jnp_engine.py
    # (JAX's pcqsdhc takes 4 s to compile)
    like_tensors(htp.pcqsdhc, *full, sg)
    like_tensors(htp.profile_rautian, a["sg0"], a["gamma_d"], a["gamma0"],
                 a["shift0"], a["anuvc"], sg)
    like_tensors(htp.profile_ht, *full, sg)
    like_tensors(htp.profile_sdvoigt, *full[:6], sg)
    like_tensors(htp.profile_sdrautian, *full[:7], sg)


@case("kernels/htp_real.py::ht_line_constants",
      "kernels/htp_real.py::pcqsdhc_real",
      "kernels/faddeeva.py::weideman_coeffs")
def case_htp_real():
    rng = np.random.default_rng(17)
    n = 6
    args = [rng.uniform(8e-4, 1.2e-3, (2, n)), rng.uniform(0.02, 0.08, (2, n)),
            rng.uniform(0.0, 0.008, (2, n)), rng.uniform(-2e-3, 2e-3, (2, n)),
            rng.uniform(-1e-4, 1e-4, (2, n)), rng.uniform(0.0, 0.03, (2, n)),
            rng.uniform(0.0, 0.3, (2, n)), rng.uniform(-0.05, 0.05, (2, n))]
    # ht_line_constants' tensor route: tests/test_torch_ht.py
    k = like_tensors(htp_real.ht_line_constants, *args)
    k = {kk: as_numpy(v) for kk, v in k.items()}
    L, a = (np.asarray(v) for v in j_fad.weideman_coeffs(16))
    dnu = np.linspace(-0.5, 0.5, 21)[:, None, None]
    got = htp_real.pcqsdhc_real(dnu, k, a, L, **CPU)
    check(got, jitted(j_htr.pcqsdhc_real, dnu, k, a, L))
    needs_card(htp_real.pcqsdhc_real, dnu, k, a, L)


@case("kernels/spectra.py::transmittance_spectrum",
      "kernels/spectra.py::absorption_spectrum",
      "kernels/spectra.py::radiance_spectrum",
      "kernels/spectra.py::convolve_spectrum")
def case_spectra():
    rng = np.random.default_rng(18)
    w = np.linspace(800.0, 810.0, 1001)
    k = 1e-3 * rng.random(1001)
    for name in ("transmittance_spectrum", "absorption_spectrum",
                 "radiance_spectrum"):
        pair(getattr(j_spec, name), getattr(spectra, name), w, k)
    for slit in ("rectangular", "gaussian"):
        pair(j_spec.convolve_spectrum, spectra.convolve_spectrum, w, k,
             resolution=0.1, af_wing=1.0, slit=slit)


@case("lines/tips.py::partition_sum", "lines/tips.py::partition_sum_ratio")
def case_tips(small):
    q = np.asarray(j_store_mod.IsoTables.load().q)
    rows = np.array([0, 5, 12, 40])
    T = np.array([150.0, 220.0, 296.0, 330.0])
    pair(j_tips.partition_sum, tips.partition_sum, q, rows, T)
    pair(j_tips.partition_sum_ratio, tips.partition_sum_ratio, q, rows, T)
    same_bits(tips.partition_sum(small["iso"].q, rows, T),
              tips.partition_sum(small["iso"].q, t(rows), t(T)))


@case("kernels/linemixing_data.py::branch_profile_full_w")
def case_branch_profile():
    rng = np.random.default_rng(19)
    nu = np.sort(rng.uniform(790.0, 794.0, 8))
    sw = rng.uniform(1e-22, 1e-20, 8)
    gamma = rng.uniform(0.05, 0.08, 8)
    el = rng.uniform(0.0, 800.0, 8)
    grid = np.linspace(789.0, 795.0, 301)
    pair(j_mixd.branch_profile_full_w, linemixing_data.branch_profile_full_w,
         grid, nu, sw, gamma, el, np.array(250.0), np.array(0.6), card=False)


@case("kernels/pallas_xsect.py::UniformGrid.from_axis",
      "kernels/pallas_xsect.py::plan_buckets",
      "kernels/pallas_xsect.py::plan_buckets_packed",
      "kernels/pallas_xsect.py::auto_block")
def case_planning():
    rng = np.random.default_rng(20)
    nu0 = np.sort(rng.uniform(800.0, 840.0, 300))
    axis = arange_drift_free(800.0, 840.0, 0.005)
    g, j_g = (fused_xsect.UniformGrid.from_axis(axis),
              j_px.UniformGrid.from_axis(axis))
    assert (g.x0, g.dx, g.n) == (j_g.x0, j_g.dx, j_g.n)
    w = rng.uniform(0.05, 2.0, nu0.size)
    for fn, j_fn, args in (
            (fused_xsect.plan_buckets, j_px.plan_buckets, (1.5,)),
            (fused_xsect.plan_buckets_packed, j_px.plan_buckets_packed, (w,))):
        p, jp = fn(nu0, g, *args, tile=512), j_fn(nu0, j_g, *args, tile=512)
        for f in ("starts", "counts", "k_line", "frac0"):
            np.testing.assert_array_equal(getattr(p, f), getattr(jp, f))
    assert fused_xsect.auto_block(nu0, g, 1.5, 512) == \
        j_px.auto_block(nu0, j_g, 1.5, 512)


# --- atmos ---------------------------------------------------------------

@case("atmos/continuum.py::continuum_od",
      "atmos/continuum.py::make_layered_mt_ckd")
def case_continuum(small):
    s = small
    nu = np.linspace(700.0, 1300.0, 301)
    # continuum_od's tensor route: tests/test_torch_od_layers.py
    same_bits(continuum.continuum_od(nu, s["atm4"], model="mt_ckd"),
              continuum.continuum_od(t(nu), s["atm4"], model="mt_ckd"))
    fn = continuum.make_layered_mt_ckd(nu, s["atm"].mol_ids, **F64)
    c = s["cols4"]
    cf = np.ones(7)
    check(fn(c["T"], c["p"], c["pl"], c["vmr"], cf),
          jitted(j_cont.make_layered_mt_ckd(nu, s["j_atm"].mol_ids),
                 c["T"], c["p"], c["pl"], c["vmr"], cf))
    same_bits(fn(c["T"], c["p"], c["pl"], c["vmr"], cf),
              fn(*(t(c[f]) for f in ("T", "p", "pl", "vmr")), t(cf)))


@case("atmos/far_wing.py::chi_factor_co2",
      "atmos/far_wing.py::cia_n2_rototranslational",
      "atmos/far_wing.py::cia_o2_fundamental")
def case_far_wing():
    dnu = np.linspace(-30.0, 30.0, 201)
    pair(j_far.chi_factor_co2, far_wing.chi_factor_co2, dnu, np.array(250.0),
         card=False)
    nu = np.linspace(0.0, 2000.0, 401)
    for name in ("cia_n2_rototranslational", "cia_o2_fundamental"):
        pair(getattr(j_far, name), getattr(far_wing, name), nu,
             np.array(250.0), card=False)


@case("atmos/regrid.py::regrid_profiles", "atmos/regrid.py::jacobian_inputs")
def case_regrid():
    rng = np.random.default_rng(21)
    z = np.linspace(0.0, 60.0, 30)
    T = 220.0 + 60.0 * rng.random((2, 30))
    h2o, o3 = 1e-3 * rng.random((2, 30)), 1e-6 * rng.random((2, 30))
    got = regrid.regrid_profiles(z, T=T, h2o=h2o, o3=o3, **F64)
    want = j_regrid.regrid_profiles(z, T=T, h2o=h2o, o3=o3,
                                    dtype=jnp.float64)
    for f in ("z0", "pl", "p", "T", "vmr"):
        check(getattr(got, f), getattr(want, f))
    needs_card(regrid.regrid_profiles, z, T=T)
    pair(j_regrid.jacobian_inputs, regrid.jacobian_inputs, T[0], h2o[0],
         o3[0], card=False)


# --- dist ------------------------------------------------------------------

@case("dist/mesh.py::pad_axis_to", "dist/checkpoint.py::host_gather")
def case_dist_arrays():
    x = np.random.default_rng(22).random((5, 3))
    pair(j_mesh.pad_axis_to, mesh_mod.pad_axis_to, x, 4)
    pair(j_mesh.pad_axis_to, mesh_mod.pad_axis_to, x, 4, axis=1, fill=2.0)
    pair(j_ckpt.host_gather, checkpoint.host_gather, x, card=False)


@case("dist/checkpoint.py::EnsembleCheckpoint.write_batch",
      "dist/checkpoint.py::TiledCheckpoint.write_tile")
def case_checkpoint(tmp_path):
    rng = np.random.default_rng(23)
    arrays = {"tau": rng.random((2, 30)), "idx": np.arange(2)}
    ck = checkpoint.EnsembleCheckpoint(str(tmp_path / "p"), 4, 2)
    jck = j_ckpt.EnsembleCheckpoint(str(tmp_path / "j"), 4, 2)
    ck.write_batch(0, arrays)
    jck.write_batch(0, arrays)
    same_bits(ck.read_batch(0), jck.read_batch(0))
    tk = checkpoint.TiledCheckpoint(str(tmp_path / "tp"), 4, 2, 2)
    jtk = j_ckpt.TiledCheckpoint(str(tmp_path / "tj"), 4, 2, 2)
    tk.write_tile(1, 0, arrays)
    jtk.write_tile(1, 0, arrays)
    same_bits(tk.read_tile(1, 0), jtk.read_tile(1, 0))


def _cpu_mesh(e, s):
    return mesh_mod.make_mesh(e, s, devices=[torch.device("cpu")] * (e * s))


@case("dist/pallas_ensemble.py::make_tud_ensemble_fn",
      "dist/pallas_ensemble.py::make_tud_ensemble_fn.run",
      "dist/pallas_ensemble.py::tud_ensemble_pallas",
      "dist/ensemble.py::tud_ensemble_sharded")
def case_tud_ensemble(small):
    s = small
    atm = s["atm4"]
    b = AtmosphericState(**{f: torch.stack([getattr(atm, f)] * 2) + (
        torch.tensor([[0.0], [5.0]], dtype=torch.float64) if f == "T" else 0)
        for f in ("z0", "z1", "pl", "p", "T")},
        vmr=torch.stack([atm.vmr] * 2), mol_ids=atm.mol_ids)
    alts = np.array([1.0, 500.0])
    mesh = _cpu_mesh(1, 2)
    g, run = fused_ensemble.make_tud_ensemble_fn(
        s["store"], s["iso"], s["axis"], b, alts, mesh, n_angles=4)
    got = run(b)
    g2, run2 = fused_ensemble.make_tud_ensemble_fn(
        s["store"], s["iso"], t(s["axis"]), b, t(alts), mesh, n_angles=4)
    same_bits(got, run2(b))
    same_bits(fused_ensemble.tud_ensemble_fused(
        s["store"], s["iso"], s["axis"], b, alts, mesh, n_angles=4)[1:], got)
    grid = s["axis"][:64]
    same_bits(tud_ensemble_sharded(s["store"], s["iso"], grid, b, alts, mesh,
                                   n_angles=4),
              tud_ensemble_sharded(s["store"], s["iso"], t(grid), b,
                                   t(alts), mesh, n_angles=4))


@case("dist/pallas_ensemble.py::make_tud_jacobian_fn",
      "dist/pallas_ensemble.py::make_tud_jacobian_fn.run")
def case_tud_jacobian_fn(small):
    s = small
    atm = s["atm4"]
    mesh = _cpu_mesh(1, 2)
    alts = np.array([500.0])
    g, run = fused_ensemble.make_tud_jacobian_fn(
        s["store"], s["iso"], s["axis"], atm, alts, mesh, n_angles=4)
    V_T, V_vmr, _ = fused_ensemble.jacobian_directions(atm, wrt=("T",))
    V_T, V_vmr = V_T[:2].astype(np.float64), V_vmr[:2].astype(np.float64)
    got = run(as_numpy(atm.T), as_numpy(atm.vmr), V_T, V_vmr)
    same_bits(got, run(atm.T, atm.vmr, t(V_T), t(V_vmr)))
    for part in got:
        for v in part.values():
            assert v.device == atm.T.device


# --- io ---------------------------------------------------------------------

@case("io/afit_xs.py::xs_write", "io/h5.py::write_h5", "io/h5.py::Var",
      "io/envi.py::write_envi", "io/mbi.py::mbi_export",
      "io/lblrtm.py::write_tape12")
def case_io_writers(tmp_path):
    rng = np.random.default_rng(24)
    X = np.linspace(800.0, 810.0, 101)
    Y = rng.random(101) * 1e-20
    p = afit_xs.xs_write(X, Y, np.float64(280.0), np.float64(1e5), 2,
                         "HITRAN", fname=str(tmp_path / "p.bin"))
    j = j_afit.xs_write(X, Y, np.float64(280.0), np.float64(1e5), 2,
                        "HITRAN", fname=str(tmp_path / "j.bin"))
    pairs = [(p, j)]
    h5.write_h5(str(tmp_path / "p.h5"), {"X": X, "Y": h5.Var(Y, units="u")})
    j_h5.write_h5(str(tmp_path / "j.h5"), {"X": X,
                                           "Y": j_h5.Var(Y, units="u")})
    pairs.append((str(tmp_path / "p.h5"), str(tmp_path / "j.h5")))
    cube = rng.random((4, 5, 6)).astype(np.float32)
    envi.write_envi(str(tmp_path / "p.hdr"), cube, wavelength=X[:6])
    j_envi.write_envi(str(tmp_path / "j.hdr"), cube, wavelength=X[:6])
    pairs += [(str(tmp_path / "p.hdr"), str(tmp_path / "j.hdr"))]
    mbi.mbi_export(str(tmp_path / "p.bip"), cube)
    j_mbi.mbi_export(str(tmp_path / "j.bip"), cube)
    pairs.append((str(tmp_path / "p.bip"), str(tmp_path / "j.bip")))
    lblrtm.write_tape12(str(tmp_path / "p12"), X, Y * 1e20)
    j_lblrtm.write_tape12(str(tmp_path / "j12"), X, Y * 1e20)
    pairs.append((str(tmp_path / "p12"), str(tmp_path / "j12")))
    for a, b in pairs:
        with open(a, "rb") as f, open(b, "rb") as g:
            assert f.read() == g.read(), (a, b)


@case("io/lblrtm.py::write_tape3", "io/lblrtm.py::tape3_to_linestore",
      "io/lblrtm.py::write_tape5", "io/lblrtm.py::default_continuum_factors")
def case_lblrtm(small, tmp_path):
    h = small["j_store"].host_view()
    n = N_LINES
    cols = (np.asarray(h.nu0), np.asarray(h.sw), np.asarray(h.gamma_air),
            np.asarray(h.elower), np.asarray(h.mol_id), np.ones(n, np.int64),
            np.asarray(h.gamma_self), np.asarray(h.n_air),
            np.asarray(h.delta_air))
    lblrtm.write_tape3(str(tmp_path / "p3"), *cols)
    j_lblrtm.write_tape3(str(tmp_path / "j3"), *cols)
    with open(tmp_path / "p3", "rb") as f, open(tmp_path / "j3", "rb") as g:
        assert f.read() == g.read()
    parsed = j_lblrtm.read_tape3(str(tmp_path / "j3"))
    st, _ = lblrtm.tape3_to_linestore(parsed, **F64)
    j_st, _ = j_lblrtm.tape3_to_linestore(parsed, dtype=jnp.float64)
    for f in ("nu0", "sw", "gamma_air", "iso_row"):
        check(getattr(st, f), getattr(j_st, f))
    mf = np.zeros(39)
    mf[[0, 1, 6, 21]] = (7000.0, 380.0, 2.1e5, 7.8e5)
    check(lblrtm.default_continuum_factors(mf),
          j_lblrtm.default_continuum_factors(mf))
    kw = dict(mf_ppmv=np.array([7000.0, 380.0, 0.03]),
              mf_ids=np.array([1, 2, 3]), continuum_factors=np.ones(7))
    lblrtm.write_tape5(str(tmp_path / "p5"), 800.0, 810.0, **kw)
    j_lblrtm.write_tape5(str(tmp_path / "j5"), 800.0, 810.0, **kw)
    with open(tmp_path / "p5", "rb") as f, open(tmp_path / "j5", "rb") as g:
        assert f.read() == g.read()


# --- lines ------------------------------------------------------------------

@case("lines/store.py::from_arrays", "lines/store.py::LineStore.subset")
def case_store(small):
    h = small["j_store"].host_view()
    cols = dict(nu0=np.asarray(h.nu0), sw=np.asarray(h.sw),
                elower=np.asarray(h.elower),
                gamma_air=np.asarray(h.gamma_air),
                gamma_self=np.asarray(h.gamma_self),
                n_air=np.asarray(h.n_air), delta_air=np.asarray(h.delta_air),
                mol_id=np.asarray(h.mol_id),
                local_iso_id=np.ones(N_LINES, np.int64))
    got = store_mod.from_arrays(**cols, **F64)
    want = j_store_mod.from_arrays(**cols)
    for f in ("nu0", "sw", "gamma_air", "iso_row", "mol_id"):
        check(getattr(got, f), getattr(want, f), dtypes=False)
    needs_card(store_mod.from_arrays, **cols)
    keep = np.arange(N_LINES) % 3 == 0
    sub, j_sub = got.subset(keep), want.subset(keep)
    check(sub.nu0, j_sub.nu0)
    same_bits(sub.sw, got.subset(t(keep)).sw)
    same_bits(got.subset(np.nonzero(keep)[0]).sw, sub.sw)


@case("lines/query.py::evaluate", "lines/query.py::filter_mask",
      "lines/query.py::group", "lines/query.py::extract_columns")
def case_query(small):
    h = small["j_store"].host_view()
    src = {"nu": np.asarray(h.nu0), "sw": np.asarray(h.sw),
           "molec_id": np.asarray(h.mol_id)}
    expr = ("*", "sw", 2.0)
    check(query.evaluate(src, expr), j_query.evaluate(src, expr))
    cond = ("AND", (">", "nu", 805.0), ("<", "sw", 1e-20))
    check(query.filter_mask(src, cond), j_query.filter_mask(src, cond))
    agg = {"n": ("COUNT", "sw")}
    check(query.group(src, ("molec_id",), agg),
          j_query.group(src, ("molec_id",), agg))
    table = {"s": np.array(["12345", "67890"])}
    check(query.extract_columns(table, "s", ("%2d", "%3d"), ("a", "b")),
          j_query.extract_columns(table, "s", ("%2d", "%3d"), ("a", "b")))


# --- scene ------------------------------------------------------------------

def _emis(n=12, nX=60, seed=25):
    rng = np.random.default_rng(seed)
    X = np.linspace(700.0, 1400.0, nX)
    E = 0.9 + 0.05 * np.sin(X[None, :] / (10.0 + np.arange(n)[:, None]))
    E = np.clip(E + 0.02 * rng.standard_normal((n, nX)), 0.5, 0.999)
    return X, E


@case("scene/emis_features.py::od_transform",
      "scene/emis_features.py::od_inverse",
      "scene/emis_features.py::pca_compress",
      "scene/emis_features.py::bspline_design",
      "scene/emis_features.py::bspline_fit_emissivity")
def case_emis_features():
    X, E = _emis()
    od_ = pair(j_feat.od_transform, emis_features.od_transform, E)
    # the tensor routes: tests/test_torch_scene.py
    like_tensors(emis_features.od_inverse, as_numpy(od_))
    like_tensors(emis_features.pca_compress, E, n_components=4)
    pair(j_feat.bspline_design, emis_features.bspline_design, X, 8,
         card=False)
    fit = emis_features.bspline_fit_emissivity(X, E.T, n_knots=8, **CPU)
    check(fit.reconstruct(), j_feat.bspline_fit_emissivity(
        X, E.T, n_knots=8).reconstruct())
    needs_card(emis_features.bspline_fit_emissivity, X, E.T, n_knots=8)


@case("scene/emis_features.py::fast_ica", "scene/emis_features.py::nmf",
      "scene/emis_features.py::ICAModel.transform",
      "scene/emis_features.py::ICAModel.inverse_transform",
      "scene/emis_features.py::NMFModel.inverse_transform")
def case_ica_nmf():
    X, E = _emis(20)
    od_ = np.asarray(j_feat.od_transform(E))
    a = emis_features.nmf(od_, 3, generator=_cpu_gen(1), n_iter=5, **CPU)
    b = emis_features.nmf(t(od_), 3, generator=_cpu_gen(1), n_iter=5)
    same_bits(a, b)
    same_bits(a.inverse_transform(as_numpy(b.W)), b.inverse_transform())
    needs_card(emis_features.nmf, od_, 3, generator=_cpu_gen(1), n_iter=5)
    ica = emis_features.fast_ica(od_, 3, generator=_cpu_gen(2), n_iter=5,
                                 **CPU)
    same_bits(ica, emis_features.fast_ica(t(od_), 3, generator=_cpu_gen(2),
                                          n_iter=5))
    S = ica.transform(od_)
    same_bits(S, ica.transform(t(od_)))
    same_bits(ica.inverse_transform(as_numpy(S)), ica.inverse_transform(S))
    # the models' transforms against JAX's on the same fitted model
    j_ica = j_feat.ICAModel(**{f.name: jnp.asarray(as_numpy(getattr(
        ica, f.name))) for f in dataclasses.fields(j_feat.ICAModel)})
    check(ica.transform(od_), j_ica.transform(od_))
    check(ica.inverse_transform(as_numpy(S)),
          j_ica.inverse_transform(as_numpy(S)))
    j_nmf = j_feat.NMFModel(W=jnp.asarray(as_numpy(a.W)),
                            H=jnp.asarray(as_numpy(a.H)))
    W = np.abs(np.random.default_rng(3).random(as_numpy(a.W).shape))
    check(a.inverse_transform(W), j_nmf.inverse_transform(W))


@case("scene/emissivity.py::EmissivityDB.from_spectra",
      "scene/emissivity.py::EmissivityDB.resample",
      "scene/emissivity.py::synthetic_db")
def case_emissivity():
    rng = np.random.default_rng(26)
    X = np.linspace(700.0, 1400.0, 71)
    db = emissivity.synthetic_db(5, X=X, seed=2, **CPU)
    j_db = j_emis.synthetic_db(5, X=X, seed=2)
    check(db.emis, j_db.emis)
    needs_card(emissivity.synthetic_db, 5, X=X, seed=2)
    X_new = np.linspace(705.0, 1395.0, 50)
    check(db.resample(X_new).emis, j_db.resample(X_new).emis)
    spectra_ = [(np.linspace(690.0, 1410.0, 200),
                 rng.uniform(0.85, 1.0, 200)) for _ in range(3)]
    got = emissivity.EmissivityDB.from_spectra(spectra_, X, **CPU)
    want = j_emis.EmissivityDB.from_spectra(spectra_, X)
    check(got.emis, want.emis)
    needs_card(emissivity.EmissivityDB.from_spectra, spectra_, X)


def _ensemble(n=30, seed=0):
    from radtxfr_tpu_torch.atmos.profile import std_atmosphere_raw
    from radtxfr_tpu_torch.cli.main import atmosgen_ensemble

    tab = std_atmosphere_raw()
    T, H2O, O3 = atmosgen_ensemble(n, seed)
    return tab[:, 1], tab[:, 4], T, H2O, O3


@case("scene/generative.py::mf2mol_cum", "scene/generative.py::mol_cum2mf",
      "scene/generative.py::mf2rh", "scene/generative.py::rh_filter",
      "scene/generative.py::trans_T", "scene/generative.py::itrans_T",
      "scene/generative.py::trans_C", "scene/generative.py::itrans_C",
      "scene/generative.py::atmos_to_features",
      "scene/generative.py::features_to_atmos")
def case_generative_transforms():
    z, P, T, H2O, O3 = _ensemble()
    j = dict(jit=True)
    c = pair(j_gen.mf2mol_cum, generative.mf2mol_cum, H2O, P, T, **j)
    pair(j_gen.mol_cum2mf, generative.mol_cum2mf, as_numpy(c), P, T, **j)
    pair(j_gen.mf2rh, generative.mf2rh, P, T, H2O, **j)
    pair(j_gen.rh_filter, generative.rh_filter, P, T, H2O * 50.0, **j)
    feats, tv, _ = pair(j_gen.trans_T, generative.trans_T, T, P, **j)
    pair(j_gen.itrans_T, generative.itrans_T, as_numpy(feats),
         [as_numpy(v) for v in tv], T=T, **j)
    cf, ctv, _ = pair(j_gen.trans_C, generative.trans_C, H2O, P, T, **j)
    pair(j_gen.itrans_C, generative.itrans_C, as_numpy(cf),
         [as_numpy(v) for v in ctv], P, T, **j)
    # the features and weights (the anomalies' mean is ~0: its relative
    # error is not a measure)
    X, tvs, wX = generative.atmos_to_features(P, T, H2O, O3,
                                              Tm=T.mean(axis=0), **CPU)
    jX, _, jwX = jitted(j_gen.atmos_to_features, P, T, H2O, O3,
                        Tm=T.mean(axis=0))
    check((X, wX), (jX, jwX))
    needs_card(generative.atmos_to_features, P, T, H2O, O3)
    tvs_np = [as_numpy(v) if isinstance(v, torch.Tensor) else
              [as_numpy(u) for u in v] if isinstance(v, tuple) else v
              for v in tvs]
    pair(j_gen.features_to_atmos, generative.features_to_atmos, as_numpy(X),
         tvs_np, P, T=T, **j)


@case("scene/generative.py::pca_fit",
      "scene/generative.py::PCAModel.transform",
      "scene/generative.py::PCAModel.inverse_transform",
      "scene/generative.py::gmm_log_prob", "scene/generative.py::gmm_predict",
      "scene/generative.py::gmm_fit", "scene/generative.py::bgmm_fit")
def case_generative_models():
    z, P, T, H2O, O3 = _ensemble()
    feats = as_numpy(generative.atmos_to_features(P, T, H2O, O3, **CPU)[0])
    # the tensor routes: tests/test_torch_scene.py
    m = like_tensors(generative.pca_fit, feats, 4)
    Z = m.transform(feats)
    same_bits(Z, m.transform(t(feats)))
    same_bits(m.inverse_transform(as_numpy(Z)), m.inverse_transform(Z))
    Xr = as_numpy(Z)
    g = generative.gmm_fit(_cpu_gen(1), Xr, 3, n_iter=10, **CPU)
    same_bits(g, generative.gmm_fit(_cpu_gen(1), t(Xr), 3, n_iter=10))
    needs_card(generative.gmm_fit, _cpu_gen(1), Xr, 3, n_iter=10)
    bg = generative.bgmm_fit(_cpu_gen(2), Xr, 3, n_iter=10, **CPU)
    same_bits(bg, generative.bgmm_fit(_cpu_gen(2), t(Xr), 3, n_iter=10))
    j_g = j_gen.GMMModel(**{f.name: jnp.asarray(as_numpy(getattr(g, f.name)))
                            for f in dataclasses.fields(j_gen.GMMModel)})
    check(generative.gmm_log_prob(g, Xr), j_gen.gmm_log_prob(j_g, Xr))
    same_bits(generative.gmm_predict(g, Xr), generative.gmm_predict(g, t(Xr)))


@case("scene/generative.py::atmos_generator",
      "scene/generative.py::airmass_labels",
      "scene/generative.py::gen_samples_per_airmass")
def case_generative_drivers():
    z, P, T, H2O, O3 = _ensemble(24)
    kw = dict(n_airmass=2)
    lab = generative.airmass_labels(_cpu_gen(0), z, P, T, H2O, O3, **kw,
                                    **CPU)
    same_bits(lab, generative.airmass_labels(_cpu_gen(0), t(z), t(P), t(T),
                                             t(H2O), t(O3), **kw))
    needs_card(generative.airmass_labels, _cpu_gen(0), z, P, T, H2O, O3,
               **kw)
    kw = dict(n_pca=3, n_gmm=2, n_aug=1)
    out = generative.gen_samples_per_airmass(
        _cpu_gen(1), z, P, T, H2O, O3, as_numpy(lab), **kw, **CPU)
    same_bits(out, generative.gen_samples_per_airmass(
        _cpu_gen(1), t(z), t(P), t(T), t(H2O), t(O3), lab, **kw))
    kw = dict(n_pca=3, n_gmm=2)
    sample, diag = generative.atmos_generator(_cpu_gen(2), P, T, H2O, O3,
                                              **kw, **CPU)
    t_sample, t_diag = generative.atmos_generator(
        _cpu_gen(2), t(P), t(T), t(H2O), t(O3), **kw)
    same_bits({k: v for k, v in diag.items() if k != "trans_vars"},
              {k: v for k, v in t_diag.items() if k != "trans_vars"})
    same_bits(sample(_cpu_gen(3), 4), t_sample(_cpu_gen(3), 4))
    needs_card(generative.atmos_generator, _cpu_gen(2), P, T, H2O, O3, **kw)


@case("scene/robust.py::mad", "scene/robust.py::robust_z",
      "scene/robust.py::qn_scale", "scene/robust.py::estimate_tau",
      "scene/planck_fit.py::fit_planck")
def case_robust_planck_fit():
    rng = np.random.default_rng(27)
    x = rng.standard_normal((20, 30)) + 0.1 * rng.standard_cauchy((20, 30))
    pair(j_robust.mad, robust.mad, x, axis=1)
    # the tensor routes: tests/test_torch_scene.py
    like_tensors(robust.mad, x)
    like_tensors(robust.robust_z, x, axis=1)
    like_tensors(robust.qn_scale, x[0, :25])
    L = 5.0 + np.abs(rng.standard_normal((15, 60)))
    like_tensors(robust.estimate_tau, L, smooth_window=9)
    X = np.linspace(800.0, 1200.0, 30)
    spec = 0.9 * np.asarray(j_planck.planckian(X, np.array(287.0))) * (
        1.0 + 0.01 * rng.standard_normal(30))
    pair(j_pfit.fit_planck, planck_fit.fit_planck, X, spec)


@case("scene/hsi.py::hsi_generate")
def case_hsi():
    rng = np.random.default_rng(28)
    nA, nX = 3, 40
    X = np.linspace(800.0, 1200.0, nX)
    tau = rng.uniform(0.3, 1.0, (nA, nX))
    Lu, Ld = (rng.uniform(0.5, 3.0, (nA, nX)) for _ in range(2))
    Ts = rng.uniform(280.0, 310.0, nA)
    E = rng.uniform(0.8, 1.0, (5, nX))
    kw = dict(n_pixels=4, n_emis=3, n_mix=2, n_atm=2)
    got = hsi.hsi_generate(_cpu_gen(3), X, tau, Lu, Ld, Ts, E, **kw, **CPU)
    same_bits(got, hsi.hsi_generate(_cpu_gen(3), t(X), t(tau), t(Lu), t(Ld),
                                    t(Ts), t(E), **kw))
    needs_card(hsi.hsi_generate, _cpu_gen(3), X, tau, Lu, Ld, Ts, E, **kw)


def on_meta(out):
    """Every tensor of ``out`` lies on the meta device."""
    for leaf in _leaves(out):
        assert isinstance(leaf, torch.Tensor), type(leaf)
        assert leaf.device.type == "meta", leaf.device


@case("kernels/faddeeva.py::cpf3", "kernels/faddeeva.py::cpf_humlicek",
      "kernels/faddeeva.py::cef", "kernels/faddeeva.py::wofz_real_series_only",
      "kernels/htp.py::pcqsdhc", "kernels/htp.py::profile_ht",
      "kernels/htp.py::profile_sdvoigt", "kernels/htp.py::profile_sdrautian",
      "kernels/htp.py::profile_rautian")
def case_scalar_arguments():
    """A Python scalar where an array may stand goes to the call's device
    as a NumPy array does: the result lies on ``device=`` ("meta" here, a
    device a fall-back to the CPU cannot reach), ``device="cpu"`` gives
    the tensor route's bits, and the all-scalar call without ``device=``
    needs the card."""
    _, y = _plane(40)
    for name in ("cpf3", "cpf_humlicek", "cef", "wofz_real_series_only"):
        fn = getattr(faddeeva, name)
        on_meta(fn(1.5, y, device="meta"))
        on_meta(fn(1.5, 0.25, device="meta"))
        like_tensors(fn, 1.5, y)
        needs_card(fn, 1.5, 0.25)
    full = list(HTP_ARGS.values())
    scalars = [float(v) for v in full]
    for params in (full, scalars):
        on_meta(htp.pcqsdhc(*params, 1000.01, device="meta"))
        on_meta(htp.profile_ht(*params, 1000.01, device="meta"))
        on_meta(htp.profile_sdvoigt(*params[:6], 1000.01, device="meta"))
        on_meta(htp.profile_sdrautian(*params[:7], 1000.01, device="meta"))
        on_meta(htp.profile_rautian(*params[:3], params[4], params[6],
                                    1000.01, device="meta"))
    like_tensors(htp.pcqsdhc, *full, 1000.01)
    needs_card(htp.pcqsdhc, *scalars, 1000.01)
    needs_card(htp.profile_rautian, *scalars[:3], scalars[4], scalars[6],
               1000.01)


def list_like_tensor(call, x):
    """``call`` on ``x`` as a nested list with ``device="cpu"`` gives the
    bits of ``call`` on the same list as a CPU tensor (torch's default
    float32); without ``device=`` it needs the card."""
    lst = np.asarray(x).tolist()
    same_bits(call(lst, **CPU), call(torch.tensor(lst)))
    needs_card(call, lst)


@case("scene/robust.py::mad", "scene/robust.py::robust_z",
      "scene/robust.py::qn_scale", "scene/robust.py::estimate_tau",
      "scene/planck_fit.py::fit_planck",
      "kernels/spectra.py::transmittance_spectrum",
      "kernels/spectra.py::absorption_spectrum",
      "kernels/spectra.py::radiance_spectrum",
      "kernels/spectra.py::convolve_spectrum",
      "scene/emis_features.py::od_transform",
      "scene/emis_features.py::od_inverse",
      "scene/emis_features.py::fast_ica", "scene/emis_features.py::nmf",
      "scene/emis_features.py::bspline_fit_emissivity",
      "scene/generative.py::pca_fit", "scene/generative.py::gmm_fit",
      "scene/generative.py::bgmm_fit", "scene/generative.py::mf2mol_cum",
      "scene/generative.py::mol_cum2mf", "scene/generative.py::mf2rh",
      "scene/generative.py::trans_T", "scene/generative.py::atmos_generator",
      "sensor/resolution.py::smooth")
def case_list_arguments():
    """A list where an array may stand keeps to ``device=``: the
    single-array entry points, and those whose first array sets the dtype
    of the rest."""
    rng = np.random.default_rng(29)
    x = rng.standard_normal((6, 9))
    list_like_tensor(lambda v, **k: robust.mad(v, axis=1, **k), x)
    list_like_tensor(lambda v, **k: robust.robust_z(v, axis=1, **k), x)
    list_like_tensor(robust.qn_scale, x[0])
    list_like_tensor(lambda v, **k: robust.estimate_tau(
        v, smooth_window=3, **k), 5.0 + np.abs(x))
    X = np.linspace(800.0, 1200.0, 9)
    spec = 0.9 * np.asarray(j_planck.planckian(X, np.array(287.0)))
    list_like_tensor(lambda v, **k: planck_fit.fit_planck(X, v, **k), spec)
    w = np.linspace(800.0, 810.0, 401)
    kk = 1e-3 * rng.random(401)
    for name in ("transmittance_spectrum", "absorption_spectrum",
                 "radiance_spectrum"):
        list_like_tensor(lambda v, f=getattr(spectra, name), **k: f(w, v, **k),
                         kk)
    list_like_tensor(lambda v, **k: spectra.convolve_spectrum(
        w, v, resolution=0.1, af_wing=1.0, **k), kk)
    XE, E = _emis(8, 30)
    list_like_tensor(emis_features.od_transform, E)
    list_like_tensor(emis_features.od_inverse, E)
    list_like_tensor(lambda v, **k: emis_features.fast_ica(
        v, 3, generator=_cpu_gen(2), n_iter=5, **k), E)
    list_like_tensor(lambda v, **k: emis_features.nmf(
        v, 3, generator=_cpu_gen(1), n_iter=5, **k), E)
    list_like_tensor(lambda v, **k: emis_features.bspline_fit_emissivity(
        XE, v, n_knots=8, **k), E.T)
    list_like_tensor(lambda v, **k: generative.pca_fit(v, 3, **k), E)
    list_like_tensor(lambda v, **k: generative.gmm_fit(
        _cpu_gen(1), v, 2, n_iter=5, **k), E[:, :4])
    list_like_tensor(lambda v, **k: generative.bgmm_fit(
        _cpu_gen(2), v, 2, n_iter=5, **k), E[:, :4])
    z, P, T, H2O, O3 = _ensemble(24)
    list_like_tensor(lambda v, **k: generative.mf2mol_cum(v, P, T, **k), H2O)
    c = as_numpy(generative.mf2mol_cum(H2O, P, T, **CPU))
    list_like_tensor(lambda v, **k: generative.mol_cum2mf(v, P, T, **k), c)
    list_like_tensor(lambda v, **k: generative.mf2rh(P, T, v, **k), H2O)
    list_like_tensor(lambda v, **k: generative.trans_T(v, P, **k), T)

    def generator_diag(v, **k):
        _, diag = generative.atmos_generator(_cpu_gen(2), P, v, H2O, O3,
                                             n_pca=3, n_gmm=2, **k)
        return {kk: d for kk, d in diag.items() if kk != "trans_vars"}

    list_like_tensor(generator_diag, T)
    list_like_tensor(lambda v, **k: resolution.smooth(v, 5, **k), x[0])


@case("utils/profiling.py::device_sync")
def case_device_sync():
    x = {"a": np.arange(4.0), "b": [np.ones(2)]}
    assert profiling.device_sync(x) is x
    assert j_profiling.device_sync(x) is x


@pytest.mark.parametrize("name", sorted(CASES))
def test_entry_point_takes_numpy(name, small, tmp_path):
    names, fn = CASES[name]
    wants = inspect.signature(fn).parameters
    fn(**{k: v for k, v in (("small", small), ("tmp_path", tmp_path))
          if k in wants})


# ---------------------------------------------------------------------------
# completeness
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

#: the builders' returned callables, which take the arrays a user calls
#: them with (JAX's: the functions its builders return)
BUILDER_CALLABLES = (
    "products/od.py::OpticalDepthFn.__call__",
    "products/od.py::CrossSectionFn.__call__",
    "products/od.py::HTCrossSectionFn.__call__",
    "products/od.py::HTOpticalDepthFn.__call__",
    "products/od.py::LocalOpticalDepthFn.__call__",
    "products/od.py::ShardOD.__call__",
    "dist/pallas_ensemble.py::make_tud_ensemble_fn.run",
    "dist/pallas_ensemble.py::make_tud_jacobian_fn.run",
    "sensor/resolution.py::ReduceOperator.__call__",
)

#: public callables that take parameters but no array, or whose arrays are
#: swept elsewhere, each with its reason; a module name covers all of it
NO_ARRAY_CASE = {
    "cli/main.py": "argparse namespaces and argv lists",
    "utils/cache.py": "a directory",
    "utils/help.py": "names",
    "utils/precision.py": "no array (a context manager)",
    "utils/retry.py": "a callable and counts",
    "utils/profiling.py::PhaseTimer.phase": "a name",
    "utils/profiling.py::trace": "a directory",
    "utils/profiling.py::MetricsLog": "a path",
    "utils/profiling.py::MetricsLog.log": "a step and scalar metrics",
    "dist/init.py": "addresses and ranks",
    "hapi_compat.py": "hapi's NumPy API: each array verb is held against "
                      "JAX's on NumPy inputs in test_torch_hapi_compat.py and "
                      "test_torch_hapi_spectra.py",
    "lines/derived.py": "band limits and quantum-number caps",
    "lines/fetch.py": "ids, band limits and payload text",
    "lines/golden.py": "a quantum-number cap",
    "lines/hapi_db.py": "paths, names and line stores",
    "lines/native_parser.py": "a path",
    "lines/synthetic.py": "counts, band limits and seeds",
    "io/afit_xs.py::xs_read": "a path",
    "io/afit_xs.py::xs_default_filename": "scalars",
    "io/envi.py::read_envi": "a path",
    "io/h5.py::read_h5": "a path",
    "io/h5.py::gen_indices": "counts and fractions",
    "io/lblrtm.py::read_tape12": "a path",
    "io/lblrtm.py::read_tape3": "a path and band limits",
    "io/mbi.py::mbi_read": "a path",
    "core/grid.py": "band limits and counts (host NumPy out in both)",
    "compat.py::make_spectral_axis": "band limits",
    "compat.py::compute_OD": "band limits and an options dict whose arrays "
                             "are host NumPy by default (test_torch_compat.py "
                             "holds it against JAX's)",
    "compat.py::compute_TUD": "as compute_OD",
    "compat.py::getHelp": "a name",
    "compat.py::run_LBLRTM": "as compute_OD",
    "compat.py::write_tape5": "a path and an options dict (text out)",
    "compat.py::read_tape12": "a path",
    "atmos/continuum.py::register_continuum": "a name and a callable",
    "atmos/continuum.py::H2OContinuumTables": "host NumPy tables by design "
                                              "(np.ndarray fields in both)",
    "atmos/continuum.py::load_mt_ckd_tables": "a path",
    "atmos/continuum.py::set_h2o_tables": "a tables object",
    "atmos/continuum.py::check_h2o_table_coverage": "band limits",
    "atmos/far_wing.py::co2_continuum_table": "band limits and a step",
    "atmos/profile.py::AtmosphericState": "a container of device tensors: "
                                          "NumPy columns enter through "
                                          "from_numpy(..., device=)",
    "atmos/profile.py::AtmosphericState.replace": "as AtmosphericState",
    "atmos/profile.py::std_atmosphere": "a dtype",
    "atmos/regrid.py::load_tigr_mat": "a path",
    "dist/checkpoint.py::EnsembleCheckpoint": "a directory and counts",
    "dist/checkpoint.py::EnsembleCheckpoint.batch_indices": "an index",
    "dist/checkpoint.py::EnsembleCheckpoint.read_batch": "an index",
    "dist/checkpoint.py::TiledCheckpoint": "a directory and counts",
    "dist/checkpoint.py::TiledCheckpoint.batch_indices": "an index",
    "dist/checkpoint.py::TiledCheckpoint.read_tile": "indices",
    "dist/checkpoint.py::TiledCheckpoint.gather": "axes",
    "dist/checkpoint.py::run_batched": "a checkpoint and a callable",
    "dist/checkpoint.py::run_tiled": "a checkpoint and a callable",
    "dist/ensemble.py::stack_states": "states (containers)",
    "dist/mesh.py::make_mesh": "counts and devices",
    "dist/pallas_ensemble.py::jacobian_directions": "a state (container); "
                                                    "NumPy out in both",
    "kernels/linemixing_data.py::co2_q_branch_y": "a temperature and counts",
    "kernels/linemixing_data.py::y_air_for_store": "a line store",
    "kernels/lineparams.py::LineParams": "a container of tensors",
    "kernels/pallas_xsect.py::UniformGrid": "scalars",
    "kernels/pallas_xsect.py::UniformGrid.values": "a dtype",
    "kernels/pallas_xsect.py::BucketPlan": "a host NumPy plan by design",
    "kernels/pallas_xsect.py::plan_executed_evals": "a plan",
    "kernels/pallas_xsect.py::xsect_fused_voigt_diff": (
        "the Pallas call on a plan's device arrays; the port's kernels take "
        "the builders' DevicePlan tensors, and the builders are cases"),
    "kernels/pallas_xsect.py::xsect_fused_sdvoigt_diff": "as the voigt one",
    "kernels/pallas_xsect.py::xsect_fused_ht_diff": "as the voigt one",
    "kernels/pallas_xsect.py::xsect_pallas": "as the voigt one",
    "kernels/pallas_xsect.py::xsect_ht_pallas": "as the voigt one",
    "kernels/pallas_tud.py::TudCfg": "K2's static sizes",
    "kernels/pallas_tud.py::tud_compose_pallas": (
        "K2's Pallas call; its callers (make_tud_fn, the ensembles) are "
        "cases"),
    "lines/query.py::select": "a line store and conditions",
    "lines/query.py::sort": "a line store",
    "lines/query.py::stick_xy": "a line store",
    "lines/store.py::IsoTables": "a container of device tensors "
                                 "(from_numpy(..., device=))",
    "lines/store.py::IsoTables.load": "a dtype",
    "lines/store.py::LineStore": "a container of device tensors "
                                 "(from_numpy(..., device=))",
    "lines/store.py::LineStore.select_band": "band limits",
    "lines/store.py::LineStore.select_molecules": "molecule ids",
    "lines/store.py::parse_par": "a path or text lines",
    "products/od.py::wing_bound_matrix": "a store, tables and a state "
                                         "(test_torch_faults_q3.py)",
    "products/od.py::max_wing_per_layer": "as wing_bound_matrix",
    "products/od.py::core_wing_per_line": "as wing_bound_matrix",
    "products/od.py::core_y_matrix": "as wing_bound_matrix",
    "products/od.py::sdvoigt_core_bound": "as wing_bound_matrix",
    "products/od.py::max_wing_bound": "as wing_bound_matrix",
    "products/od_from_xs.py::XsTable": "a container of device tensors",
    "products/od_from_xs.py::xs_table_from_files": "paths",
    "products/tud.py::TUD": "a container of tensors",
    "products/tud.py::downwelling_angles": "a count",
    "products/tud.py::downwelling_quadrature": "a count",
    "scene/emis_features.py::ICAModel": "a container of tensors",
    "scene/emis_features.py::NMFModel": "a container of tensors",
    "scene/emis_features.py::BSplineFit": "a container of tensors",
    "scene/emissivity.py::EmissivityDB": "a container of tensors",
    "scene/emissivity.py::EmissivityDB.pairwise_mixtures": "counts",
    "scene/emissivity.py::save_db": "a database and a path",
    "scene/emissivity.py::load_db": "a path",
    "scene/emissivity.py::read_aster_export": "a path",
    "scene/emissivity.py::load_aster_dir": "a directory and band limits",
    "scene/generative.py::PCAModel": "a container of tensors",
    "scene/generative.py::GMMModel": "a container of tensors",
    "scene/generative.py::gmm_prune": "a model",
    "scene/generative.py::gmm_sample": "a generator, a model and a count",
}


def _jax_public(rel):
    """(qualified name, callable) of the JAX module's public callables
    that take a parameter: its public functions and classes (jitted and
    cached ones included) and each class's public methods."""
    cov = importlib.import_module("test_torch_api_coverage")
    mod = importlib.import_module(cov._module_name("radtxfr_tpu", rel))
    names = list(cov._public(mod))
    names += [n for n, v in vars(mod).items() if not n.startswith("_")
              and n not in names and callable(v) and not inspect.isclass(v)
              and getattr(v, "__module__", None) == mod.__name__]
    out = []
    for name in names:
        if (rel, name) == ("dist/mesh.py", "P"):
            continue                 # jax.sharding.PartitionSpec
        for qual, obj in cov._callables(name, getattr(mod, name)):
            try:
                params = [p for p in inspect.signature(obj).parameters
                          if p not in ("self", "cls")]
            except (TypeError, ValueError):
                params = ["?"]
            if params:
                out.append(qual)
    return out


def test_every_array_entry_point_is_swept():
    """Every public JAX callable that takes a parameter, and every
    builder's returned callable, is a case or has a reason here; every
    case and reason names something that exists."""
    cov = importlib.import_module("test_torch_api_coverage")
    covered = {n for names, _ in CASES.values() for n in names}
    universe = {f"{rel}::{q}" for rel in cov.JAX_MODULES
                for q in _jax_public(rel)} | set(BUILDER_CALLABLES)
    listed = lambda key: key in NO_ARRAY_CASE or \
        key.split("::")[0] in NO_ARRAY_CASE  # noqa: E731
    missing = sorted(k for k in universe if k not in covered
                     and not listed(k))
    assert not missing, missing
    stale = sorted(k for k in set(NO_ARRAY_CASE) | covered
                   if "::" in k and k not in universe)
    assert not stale, stale
    assert not covered & set(NO_ARRAY_CASE)
    modules = {k for k in NO_ARRAY_CASE if "::" not in k}
    assert modules <= set(cov.JAX_MODULES)
    assert all(v.strip() for v in NO_ARRAY_CASE.values())
