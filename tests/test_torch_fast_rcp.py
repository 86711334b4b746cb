"""``fast_rcp``, the TPU kernels' fast reciprocal (``pl.reciprocal(x,
approx=True)`` and one Newton step where ``pallas_xsect.py`` calls
``_rcp(., fast)``), through the port's six builders and the prebuilt-plan
route of ``compute_od_layers``, against radtxfr_tpu.

Each builder takes ``fast_rcp`` with JAX's default (True; the prebuilt-plan
route's ``pallas_opts`` False unless given, as ``xsect_pallas``). On the CPU
both packages divide in IEEE whatever it says: JAX drops it in interpret
mode (``fast_rcp and not interpret``) and the port's plain versions take
IEEE division on the CPU (``fused_xsect.plain_rcp``), so each case holds the port's float32 result to JAX's builder with the
same ``fast_rcp`` (interpret mode) within the bound of that builder's
existing parity test, and the port's results for True and False to each
other bit for bit. The fast instantiations themselves run on the card only
(``tests/test_torch_cuda.py``). Inputs come from fixed seeds, handed to both
packages.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
from radtxfr_tpu.kernels import htp_real as j_htp_real
from radtxfr_tpu.kernels.faddeeva import weideman_coeffs
from radtxfr_tpu.lines.store import IsoTables as JIsoTables
from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic
from radtxfr_tpu.products import od as j_od
from radtxfr_tpu.products.od import make_od_pallas_local_fn as j_local_fn
from radtxfr_tpu.products.od_sharded_lines import \
    make_od_sharded_lines_fn as j_lines_fn
from radtxfr_tpu_torch.atmos.profile import AtmosphericState
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.kernels import htp_real
from radtxfr_tpu_torch.lines.store import IsoTables, LineStore
from radtxfr_tpu_torch.products import od
from radtxfr_tpu_torch.products.od_sharded_lines import \
    make_od_sharded_lines_fn
from port_fixtures import one_torch_thread  # noqa: F401

FIELDS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
          "delta_air", "sd_air", "iso_row", "mol_id")
STATE = ("z0", "z1", "pl", "p", "T", "vmr")
#: the builders' parity bounds of their existing tests, of the peak, float32
#: against JAX's float32 Pallas kernels: the line OD with mixing and the
#: sharded builders (test_torch_dist.py's OD_BOUND), the SD-Voigt lattice
#: (test_torch_xsect.py's SD_BOUND), the HT builders (test_torch_ht.py's
#: HT_BOUND) and K7 (test_torch_od_layers.py's unfused-kernel bound)
OD_BOUND, SD_BOUND, HT_BOUND, K7_BOUND = 3e-6, 1e-5, 5e-5, 2e-6
#: the entry points; "default" passes no fast_rcp to either package
ENTRIES = ("make_od_fn", "make_xsect_fn", "make_ht_fn", "make_od_ht_fn",
           "make_od_local_fn", "make_od_sharded_lines_fn",
           "compute_od_layers_plan")
SETTINGS = (True, False, "default")
N_SHARDS = 2


def _port_store(store, dtype=torch.float32):
    hv = jax.device_get(store)
    return LineStore.from_numpy(**{f: np.asarray(getattr(hv, f))
                                   for f in FIELDS}, device="cpu",
                                dtype=dtype)


def _port_iso(iso_tables):
    iso = jax.device_get(iso_tables)
    return IsoTables.from_numpy(**{f: getattr(iso, f) for f in
                                   ("q", "abundance", "molar_mass", "mol",
                                    "iso")}, device="cpu",
                                dtype=torch.float32)


def _layers(idx):
    """Standard-atmosphere layers ``idx`` for both packages (float32)."""
    j_atm = j_std_atmosphere()
    j_atm = j_atm.replace(**{f: getattr(j_atm, f)[idx] for f in STATE})
    atm = AtmosphericState.from_numpy(
        **{f: np.asarray(getattr(j_atm, f)) for f in STATE},
        mol_ids=j_atm.mol_ids, device="cpu", dtype=torch.float32)
    return j_atm, atm


def _j_state(j_atm):
    return tuple(jnp.asarray(getattr(j_atm, f), jnp.float32)
                 for f in ("T", "p", "pl", "vmr"))


def _ht_lines(n=60, lo=995.0, hi=1015.0):
    """Lines with live HT columns on a third of them, SD-Voigt and Voigt
    on the rest (tests/test_torch_ht.py's mix: all three routes)."""
    kw = dict(nu_min=lo, nu_max=hi, seed=31, sd_zero_frac=0.4)
    rng = np.random.default_rng(7)
    on = np.arange(n) < n // 3
    extras = {"nu_HT_air": rng.uniform(0.01, 0.05, n) * on,
              "kappa_HT_air": rng.uniform(0.0, 1.0, n) * on,
              "eta_HT_air": rng.uniform(0.1, 0.3, n) * on,
              "delta_HT_2_air_296": rng.normal(0.0, 5e-4, n) * on}
    j_store = j_synthetic(n, **kw)
    return j_store, _port_store(j_store), extras


def _opt(fast):
    return {} if fast == "default" else {"fast_rcp": fast}


@functools.lru_cache(maxsize=None)
def _case(entry):
    """The inputs of one entry point: (JAX runner, port runner, bound);
    each runner takes a setting of SETTINGS and returns NumPy outputs."""
    iso_tables = JIsoTables.load()
    iso = _port_iso(iso_tables)
    if entry in ("make_od_fn", "make_od_local_fn",
                 "make_od_sharded_lines_fn", "compute_od_layers_plan"):
        j_store = j_synthetic(120, nu_min=790.0, nu_max=860.0, seed=33,
                              sd_zero_frac=1.0)
        store = _port_store(j_store)
        j_atm, atm = _layers(np.linspace(0, 60, 5).astype(int))
        axis = arange_drift_free(800.0, 850.0, 0.02)
    if entry == "make_od_fn":
        rng = np.random.default_rng(7)
        y_air = rng.normal(0.0, 0.05, 120)
        y_air[::3] = 0.0
        kw = dict(line_mixing={"y_air": y_air, "n_T": 0.75},
                  continuum="mt_ckd")

        def jax_run(fast):
            fn = j_od.make_od_pallas_fn(j_store, iso_tables, axis, j_atm,
                                        **kw, **_opt(fast))
            return [np.asarray(fn(*_j_state(j_atm)))]

        def port_run(fast):
            fn = od.make_od_fn(store, iso, axis, atm, **kw, **_opt(fast))
            assert fn.fast_rcp is (fast is not False)
            assert {c[2] for c in fn.calls} == {"asym", "core", "mix"}
            return [fn(atm.T, atm.p, atm.pl, atm.vmr).numpy()]

        return jax_run, port_run, OD_BOUND
    if entry == "make_xsect_fn":
        kw = dict(nu_min=795.0, nu_max=825.0, seed=9, sd_zero_frac=0.3)
        j_store = j_synthetic(100, **kw)
        store = _port_store(j_store)
        axis = arange_drift_free(800.0, 820.0, 0.005)
        T, p = np.array([275.0, 296.0, 320.0]), np.array([0.85, 1.0, 1.05])
        args = dict(profile="sdvoigt", wing_abs=40.0, far_method="coarse",
                    coarse_r=16)

        def jax_run(fast):
            fn = j_od.make_xsect_pallas_fn(j_store, iso_tables, axis, T, p,
                                           **args, **_opt(fast))
            return [np.asarray(fn(jnp.asarray(T, jnp.float32),
                                  jnp.asarray(p, jnp.float32)))]

        def port_run(fast):
            fn = od.make_xsect_fn(store, iso, axis, T, p, **args,
                                  **_opt(fast))
            assert fn.coarse_calls and fn.corr_calls
            return [fn(torch.as_tensor(T, dtype=torch.float32),
                       torch.as_tensor(p, dtype=torch.float32)).numpy()]

        return jax_run, port_run, SD_BOUND
    if entry == "make_ht_fn":
        j_store, store, extras = _ht_lines()
        axis = arange_drift_free(1001.0, 1009.0, 0.01)
        T, p = np.array([260.0, 296.0, 320.0]), np.array([0.8, 1.0, 0.9])
        kw = dict(extras=extras, far_method="classic", max_groups=1)

        def jax_run(fast):
            fn = j_od.make_ht_pallas_fn(j_store, iso_tables, axis, T, p,
                                        **kw, **_opt(fast))
            return [np.asarray(fn(jnp.asarray(T, jnp.float32),
                                  jnp.asarray(p, jnp.float32)))]

        def port_run(fast):
            fn = od.make_ht_fn(store, iso, axis, T, p, **kw, **_opt(fast))
            assert {c[2] for c in fn.calls} == {"ht", "sdvoigt", "full"}
            return [fn(torch.as_tensor(T, dtype=torch.float32),
                       torch.as_tensor(p, dtype=torch.float32)).numpy()]

        return jax_run, port_run, HT_BOUND
    if entry == "make_od_ht_fn":
        j_store, store, extras = _ht_lines(90, 795.0, 835.0)
        j_atm, atm = _layers(np.linspace(0, 60, 3).astype(int))
        axis = arange_drift_free(805.0, 815.0, 0.01)
        kw = dict(extras=extras, max_groups=1, differentiable=True)

        def jax_run(fast):
            fn = j_od.make_od_ht_pallas_fn(j_store, iso_tables, axis, j_atm,
                                           **kw, **_opt(fast))
            return [np.asarray(fn(*_j_state(j_atm)))]

        def port_run(fast):
            fn = od.make_od_ht_fn(store, iso, axis, atm, **kw, **_opt(fast))
            assert {c[2] for c in fn.calls} == {"ht", "sdvoigt", "full"}
            return [fn(atm.T, atm.p, atm.pl, atm.vmr).numpy()]

        return jax_run, port_run, HT_BOUND
    if entry in ("make_od_local_fn", "make_od_sharded_lines_fn"):
        local = entry == "make_od_local_fn"
        j_build = j_local_fn if local else j_lines_fn
        build = od.make_od_local_fn if local else make_od_sharded_lines_fn

        def jax_run(fast):
            fn, spec, g = j_build(j_store, iso_tables, axis, j_atm, N_SHARDS,
                                  **_opt(fast))
            n_local = g.n // N_SHARDS
            return [np.asarray(fn(*_j_state(j_atm),
                                  jax.tree.map(lambda a: a[s:s + 1], spec),
                                  s * n_local)) for s in range(N_SHARDS)]

        def port_run(fast):
            fn, spec, g = build(store, iso, axis, atm, N_SHARDS,
                                **_opt(fast))
            n_local = g.n // N_SHARDS
            out = []
            for s in range(N_SHARDS):
                loc = od.shard_slice(spec, s)
                if local:
                    # the bound shard (ShardOD) the sharded ensemble runs
                    shard = fn.bind(loc, s * n_local)
                    assert shard.fn.fast_rcp is (fast is not False)
                    out.append(shard(atm.T, atm.p, atm.pl, atm.vmr).numpy())
                else:
                    out.append(fn(atm.T, atm.p, atm.pl, atm.vmr, loc,
                                  s * n_local).numpy())
            return out

        return jax_run, port_run, OD_BOUND
    # compute_od_layers on a prebuilt plan: K7, fast_rcp an evaluation
    # option (False unless given)
    j_plan = j_od.make_od_plan(j_store, iso_tables, axis, j_atm)
    plan = od.make_od_plan(store, iso, axis, atm)

    def popt(fast):
        return {} if fast == "default" else {"pallas_opts":
                                             {"fast_rcp": fast}}

    def jax_run(fast):
        return [np.asarray(j_od.compute_od_layers(
            j_store, iso_tables, jnp.asarray(axis), j_atm, engine="pallas",
            plan=j_plan, **popt(fast)))]

    def port_run(fast):
        return [od.compute_od_layers(store, iso, axis, atm, engine="pallas",
                                     plan=plan, **popt(fast)).numpy()]

    return jax_run, port_run, K7_BOUND


@functools.lru_cache(maxsize=None)
def _run(entry, side, fast):
    jax_run, port_run, _ = _case(entry)
    return (jax_run if side == "jax" else port_run)(fast)


@pytest.mark.parametrize("fast", SETTINGS, ids=lambda f: f"fast_rcp={f}")
@pytest.mark.parametrize("entry", ENTRIES)
def test_fast_rcp_matches_jax_and_is_ieee_on_the_cpu(entry, fast):
    """The port (float32, the kernels' plain versions) against JAX's
    builder with the same ``fast_rcp`` (interpret mode) within the
    builder's parity bound of the peak, and the port's result bit-identical
    to its result with the other setting."""
    want = _run(entry, "jax", fast)
    got = _run(entry, "port", fast)
    other = _run(entry, "port", fast is False)
    peak = max(np.abs(w).max() for w in want)
    assert peak > 0.0
    bound = _case(entry)[2]
    for g, w, o in zip(got, want, other):
        assert g.shape == w.shape
        assert np.abs(g - w).max() <= bound * peak, \
            np.abs(g - w).max() / peak
        np.testing.assert_array_equal(g, o)


def test_pcqsdhc_real_fast_raises_in_both_packages():
    """Outside a kernel ``pcqsdhc_real(fast=True)`` raises in both: JAX's
    ``pl.reciprocal`` has no evaluation rule there, the port's function
    divides in IEEE (its fast reciprocal is K5's); ``fast=False`` agrees
    within float32 rounding."""
    keys = ("cte", "c0tr", "c0ti", "c2tr", "c2ti", "cyr", "cyi", "d0r",
            "d0i", "e2r", "e2i")
    vals = dict(zip(keys, (0.5, 0.01, 0.0, 0.002, 0.0, 3.0, 0.0, 0.001,
                           0.0, 0.0005, 0.0)))
    L, a = weideman_coeffs(16)
    dnu = np.linspace(-0.5, 0.5, 9).astype(np.float32)
    k = {key: np.full(dnu.shape, v, np.float32) for key, v in vals.items()}
    with pytest.raises(NotImplementedError):
        j_htp_real.pcqsdhc_real(dnu, k, a, L, fast=True)
    with pytest.raises(NotImplementedError, match="fast"):
        htp_real.pcqsdhc_real(dnu, k, a, L, fast=True, device="cpu")
    want = np.asarray(j_htp_real.pcqsdhc_real(dnu, k, a, L))
    got = htp_real.pcqsdhc_real(dnu, k, a, L, device="cpu").numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_fast_builds_and_entries():
    """Each kernel source with a FAST instantiation has a ``*_fast.cu``
    beside it that sets RADTXFR_FAST and includes it (one library each,
    built in parallel); the C entries of those builds are the ones
    ``_build.entry(name, fast=True)`` looks up, with the same arguments, and
    K6 (JAX's tangent kernel forces fast=False), K2 and the probe have none:
    asking for one raises before anything is built."""
    import os

    from radtxfr_tpu_torch import _build

    for stem in ("fused_xsect", "fused_xsect_jvp", "fused_ht"):
        with open(os.path.join(_build.CSRC, f"{stem}_fast.cu")) as f:
            src = f.read()
        assert "#define RADTXFR_FAST 1" in src
        assert f'#include "{stem}.cu"' in src
        assert _build._with_includes(
            os.path.join(_build.CSRC, f"{stem}_fast.cu"))[1].endswith(
                f"{stem}.cu")
    for name in _build.FAST_ENTRIES:
        assert _build._SIGNATURES[f"{name}_fast"] == _build._SIGNATURES[name]
    for name in ("radtxfr_fused_ht_jvp", "radtxfr_fused_tud",
                 "radtxfr_fp32_probe"):
        with pytest.raises(ValueError, match="FAST"):
            _build.entry(name, fast=True)


def test_card_fast_rcp_rebuilds_from_the_table():
    """``fused_xsect.card_fast_rcp``, the plain versions' copy of the card's
    fast reciprocal, takes a normal x's approximate reciprocal from the
    2^23-entry mantissa table with x's exponent taken off the entry's bits,
    then the Newton step. Handed the table of IEEE reciprocals of [1, 2),
    it must give the Newton step on IEEE 1/x bit for bit, for x across
    every exponent, both signs and the edge values (0, subnormals, 2^126
    and above, inf, NaN: those start from IEEE 1/x). On the CPU
    ``plain_rcp`` is IEEE division whatever ``fast`` says, and so is it in
    float64."""
    from radtxfr_tpu_torch.kernels import fused_xsect

    m = torch.arange(1 << 23, dtype=torch.int32) | 0x3F800000
    table = (1.0 / m.view(torch.float32)).view(torch.int32)
    rng = np.random.default_rng(18)
    bits = rng.integers(0, 2 ** 32, 400_000, dtype=np.uint64)
    x = torch.from_numpy(bits.astype(np.uint32).view(np.float32).copy())
    f32 = np.float32
    edges = torch.tensor([0.0, -0.0, 1.0, -1.0, 2.0, 1.5, f32(2.0 ** -126),
                          f32(1e-40), f32(2.0 ** 126), f32(3e38),
                          float("inf"), -float("inf"), float("nan")],
                         dtype=torch.float32)
    x = torch.cat([x, edges])
    got = fused_xsect.card_fast_rcp(x, table)
    r = 1.0 / x
    want = r * (2.0 - x * r)
    same = (got.view(torch.int32) == want.view(torch.int32)) | (
        torch.isnan(got) & torch.isnan(want))
    assert bool(same.all()), x[~same][:5]
    cpu32 = torch.ones(2, dtype=torch.float32)
    assert fused_xsect.plain_rcp(True, cpu32) is fused_xsect._ieee_rcp
    assert fused_xsect.plain_rcp(False, cpu32) is fused_xsect._ieee_rcp
    assert fused_xsect.plain_rcp(True, cpu32.double()) is \
        fused_xsect._ieee_rcp
