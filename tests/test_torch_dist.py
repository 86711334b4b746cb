"""The port's sharded production path against radtxfr_tpu and against its
own unsharded path: the local OD builder (``make_od_local_fn``) and its
plans, the line-sharded builder, the mesh, the sharded ensemble and
Jacobian builders, ``tud --mesh-*`` and the multi-process helpers.

The JAX side runs its builders' per-shard functions directly, shard by
shard (``local_fn`` with shard s's slice of ``spec_data`` and ``k_offset =
s * n_local``), its Pallas kernels in interpret mode, and never its
``shard_map`` programs (slow-marked in tier-1). JAX's kernels compute in
float32 whatever the inputs, so the port's per-shard OD is held to them in
float32 at each pass's float32 bound, and to its own unsharded builders in
float64 (the shards are the unsharded output's columns). The mesh is
virtual: ``make_mesh(E, S, devices=[cpu] * (E * S))``, the counterpart of
the JAX tests' 8-device CPU mesh. Sizes follow ``tests/test_dist.py``:
800-850 cm^-1 at 0.02, 2-4 shards, the first five StdAtmos layers.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import radtxfr_tpu.atmos as j_atmos
from radtxfr_tpu.atmos import std_atmosphere as j_std_atmosphere
from radtxfr_tpu.atmos.continuum import continuum_od as j_continuum_od
from radtxfr_tpu.cli.main import build_parser as j_build_parser
from radtxfr_tpu.core.planck import planckian as j_planckian
from radtxfr_tpu.kernels.pallas_xsect import UniformGrid as JGrid
from radtxfr_tpu.lines.synthetic import synthetic_lines as j_synthetic
from radtxfr_tpu.products.jacobian import tud_with_jacobian as j_jacobian
from radtxfr_tpu.products.od import _line_species_cols as j_species_cols
from radtxfr_tpu.products.od import compute_od_layer as j_od_layer
from radtxfr_tpu.products.od import make_od_pallas_fn as j_od_fn
from radtxfr_tpu.products.od import make_od_pallas_local_fn as j_local_fn
from radtxfr_tpu.products.od_sharded_lines import \
    make_od_sharded_lines_fn as j_lines_fn
from radtxfr_tpu.products.tud import make_tud_pallas_fn as j_tud_fn
from radtxfr_tpu.products.tud import tud_from_od as j_tud_from_od
from radtxfr_tpu_torch.atmos.continuum import continuum_od
from radtxfr_tpu_torch.atmos.profile import AtmosphericState
from radtxfr_tpu_torch.cli.main import build_parser, run_tud
from radtxfr_tpu_torch.core.grid import arange_drift_free
from radtxfr_tpu_torch.core.planck import planckian
from radtxfr_tpu_torch.dist import (ENSEMBLE, SPECTRUM, make_mesh,
                                    stack_states, tud_ensemble_sharded)
from radtxfr_tpu_torch.dist.fused_ensemble import (jacobian_directions,
                                                   make_tud_ensemble_fn,
                                                   make_tud_jacobian_fn)
from radtxfr_tpu_torch.dist.mesh import pad_axis_to
from radtxfr_tpu_torch.lines.store import IsoTables, LineStore
from radtxfr_tpu_torch.products.jacobian import tud_with_jacobian
from radtxfr_tpu_torch.products.od import (_line_species_cols,
                                           compute_od_layer, make_od_fn,
                                           make_od_local_fn, shard_slice)
from radtxfr_tpu_torch.products.od_sharded_lines import \
    make_od_sharded_lines_fn
from radtxfr_tpu_torch.products.tud import make_tud_fn, tud_from_od
from port_fixtures import one_torch_thread  # noqa: F401

FIELDS = ("nu0", "sw", "elower", "gamma_air", "gamma_self", "n_air",
          "delta_air", "sd_air", "iso_row", "mol_id")
STATE = ("z0", "z1", "pl", "p", "T", "vmr")
AXIS = arange_drift_free(800.0, 850.0, 0.02)            # 2501 points
ALTS = [2.0, 500.0]
N_LAY = 5
#: the float32 bound of the line OD against JAX's kernels, of the peak
#: (test_torch_fused_xsect.py; test_dist.py holds the sharded JAX OD to
#: its unsharded one at 5e-6); SD-Voigt's (test_torch_xsect.py)
OD_BOUND, SD_BOUND, TANGENT_BOUND = 3e-6, 1e-5, 2e-5
#: TUD products against JAX's float32 kernels, of each product's peak
#: (K2's, test_torch_fused_tud.py; the primal of tud_with_jacobian's,
#: test_torch_jacobian.py), and the TUD Jacobians against JAX's Pallas
#: engine (test_torch_jacobian.py, the JAX package's bound between its
#: Jacobian engines, test_pallas_xsect.py:376); float64 against JAX's
#: reference engine (test_torch_jnp_engine.py)
TUD_BOUND, JAC_BOUND, F64_BOUND = 5e-6, 5e-4, 1e-12


def _cpu_mesh(n_ens, n_spec):
    return make_mesh(n_ens, n_spec,
                     devices=[torch.device("cpu")] * (n_ens * n_spec))


def _boundary_lines(n, seed, sd_zero_frac=1.0, nu_min=790.0, nu_max=860.0):
    """JAX synthetic lines with the lines nearest 820.48 and 840.96 cm^-1
    (grid indices 1024 and 2048 of the 0.02 axis: shard and chunk edges of
    every partition here) moved onto them and made 50 times stronger."""
    store = j_synthetic(n, nu_min=nu_min, nu_max=nu_max, seed=seed,
                        sd_zero_frac=sd_zero_frac)
    nu0 = np.asarray(store.nu0, dtype=np.float64).copy()
    sw = np.asarray(store.sw).copy()
    for b in (AXIS[0] + 0.02 * 1024, AXIS[0] + 0.02 * 2048):
        i = int(np.argmin(np.abs(nu0 - b)))
        nu0[i], sw[i] = b, sw[i] * 50.0
    order = np.argsort(nu0, kind="stable")
    store = jax.tree.map(lambda a: jnp.asarray(np.asarray(a)[order]), store)
    return dataclasses.replace(store, nu0=jnp.asarray(nu0[order]),
                               sw=jnp.asarray(sw[order]))


def _atm():
    full = j_std_atmosphere()
    return full.replace(**{f: getattr(full, f)[:N_LAY] for f in STATE})


def _jax_state(st):
    """The JAX package's state holding a port state's values."""
    return _atm().replace(**{f: jnp.asarray(getattr(st, f).numpy())
                             for f in STATE})


def _rel(got, want):
    want = np.asarray(want)
    return np.abs(np.asarray(got) - want).max() / np.abs(want).max()


def _port(store, iso_tables, atm, dtype):
    hv = jax.device_get(store)
    iso = jax.device_get(iso_tables)
    return (LineStore.from_numpy(**{f: np.asarray(getattr(hv, f))
                                    for f in FIELDS},
                                 device="cpu", dtype=dtype),
            IsoTables.from_numpy(**{f: getattr(iso, f) for f in
                                    ("q", "abundance", "molar_mass", "mol",
                                     "iso")}, device="cpu", dtype=dtype),
            AtmosphericState.from_numpy(
                **{f: np.asarray(getattr(atm, f)) for f in STATE},
                mol_ids=atm.mol_ids, device="cpu", dtype=dtype))


@pytest.fixture(scope="module")
def voigt(iso_tables):
    """150 synthetic lines (strong ones on the shard edges), five layers,
    and the port's float32 and float64 copies."""
    store, atm = _boundary_lines(150, 33, sd_zero_frac=1.0), _atm()
    return dict(store=store, atm=atm,
                f32=_port(store, iso_tables, atm, torch.float32),
                f64=_port(store, iso_tables, atm, torch.float64))


def _mixing(n):
    rng = np.random.default_rng(7)
    y_air = rng.normal(0.0, 0.05, n)
    y_air[::3] = 0.0
    return {"y_air": y_air, "n_T": 0.75}


#: (partition, the builder's options): the per-shard cases
CASES = {
    "equal": ("equal", {}),
    "weighted_mt_ckd": ("weighted", {"continuum": "mt_ckd"}),
    "single_pass": ("equal", {"two_pass": False}),
    "mixing_mt_ckd": ("weighted", {"continuum": "mt_ckd", "mixing": True}),
}


def _opts(c, extra):
    extra = dict(extra)
    if extra.pop("mixing", False):
        extra["line_mixing"] = _mixing(len(c["store"].nu0))
    return extra


def _j_shards(fn, spec, gpad, n_spec, atm):
    n_local = gpad.n // n_spec
    out = []
    for s in range(n_spec):
        loc = jax.tree.map(lambda a: a[s:s + 1], spec)
        out.append(np.asarray(fn(atm.T, atm.p, atm.pl, atm.vmr, loc,
                                 s * n_local)))
    return out


def _p_shards(fn, spec, gpad, n_spec, st):
    n_local = gpad.n // n_spec
    return [fn(st.T, st.p, st.pl, st.vmr, shard_slice(spec, s),
               s * n_local).numpy() for s in range(n_spec)]


def _same_spec(got, want):
    if isinstance(want, dict):
        assert isinstance(got, dict)
        np.testing.assert_array_equal(got["point_idx"].numpy(),
                                      np.asarray(want["point_idx"]))
        got, want = got["calls"], want["calls"]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for a, b in zip(g, w):
            assert a.dtype == torch.int32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("case", list(CASES))
def test_local_plans_match_jax(voigt, iso_tables, case):
    """The padded grid, each call's per-shard starts/counts (and, weighted,
    tile offsets and point indices) integer-exact against the JAX
    builder's, and each call's mode and layers."""
    partition, extra = CASES[case]
    opts = _opts(voigt, extra)
    j_fn, j_spec, j_g = j_local_fn(voigt["store"], iso_tables, AXIS,
                                   voigt["atm"], 4, partition=partition,
                                   **opts)
    lines, iso, st = voigt["f64"]
    fn, spec, g = make_od_local_fn(lines, iso, AXIS, st, 4,
                                   partition=partition, **opts)
    assert (g.x0, g.dx, g.n) == (j_g.x0, j_g.dx, j_g.n)
    assert fn.partition == partition
    _same_spec(spec, j_spec)
    if partition == "weighted":
        np.testing.assert_array_equal(fn.point_index, j_fn.point_index)
        assert np.array_equal(np.sort(fn.point_index.ravel()),
                              np.arange(g.n))
    else:
        assert fn.point_index is None and j_fn.point_index is None


@pytest.mark.parametrize("case", list(CASES))
def test_local_od_matches_jax(voigt, iso_tables, case):
    """Each shard's OD (float32, the kernels' plain versions) against the
    JAX builder's ``local_fn`` for that shard, and (float64) the shards
    gathered against the port's unsharded ``make_od_fn`` on the padded
    grid with the same options: equal to the last bit."""
    partition, extra = CASES[case]
    opts = _opts(voigt, extra)
    j_fn, j_spec, j_g = j_local_fn(voigt["store"], iso_tables, AXIS,
                                   voigt["atm"], 4, partition=partition,
                                   **opts)
    want = _j_shards(j_fn, j_spec, j_g, 4, voigt["atm"])
    lines, iso, st = voigt["f32"]
    fn, spec, g = make_od_local_fn(lines, iso, AXIS, st, 4,
                                   partition=partition, **opts)
    got = _p_shards(fn, spec, g, 4, st)
    peak = max(np.abs(w).max() for w in want)
    for s in range(4):
        assert got[s].shape == want[s].shape == (N_LAY, g.n // 4)
        assert np.abs(got[s] - want[s]).max() <= OD_BOUND * peak, \
            (s, np.abs(got[s] - want[s]).max() / peak)

    lines, iso, st = voigt["f64"]
    fn, spec, g = make_od_local_fn(lines, iso, AXIS, st, 4,
                                   partition=partition, **opts)
    shards = _p_shards(fn, spec, g, 4, st)
    full = make_od_fn(lines, iso, g, st, group_ratio=1.6,
                      far_method="classic", **opts)(st.T, st.p, st.pl,
                                                    st.vmr).numpy()
    cols = (fn.point_index if fn.point_index is not None
            else np.arange(g.n).reshape(4, -1))
    gathered = np.empty_like(full)
    for s in range(4):
        gathered[:, cols[s]] = shards[s]
    np.testing.assert_array_equal(gathered, full)


def test_local_sdvoigt_and_tangents_match_jax(iso_tables):
    """``profile='sdvoigt'`` (its SD-Voigt and Voigt passes) per shard, and
    ``differentiable=True``'s tangents (K3 for the Voigt lines, K4 for the
    SD-Voigt ones) per shard along a T direction over all layers against
    ``jax.jvp`` of the JAX ``local_fn``, float32, weighted partition."""
    store, atm = _boundary_lines(60, 36, sd_zero_frac=0.5), _atm()
    lines, iso, st = _port(store, iso_tables, atm, torch.float32)
    j_fn, j_spec, j_g = j_local_fn(store, iso_tables, AXIS, atm, 2,
                                   profile="sdvoigt")
    want = _j_shards(j_fn, j_spec, j_g, 2, atm)
    fn, spec, g = make_od_local_fn(lines, iso, AXIS, st, 2,
                                   profile="sdvoigt")
    got = _p_shards(fn, spec, g, 2, st)
    peak = max(np.abs(w).max() for w in want)
    for s in range(2):
        assert np.abs(got[s] - want[s]).max() <= SD_BOUND * peak

    v = np.linspace(0.5, 1.5, N_LAY)
    j_fn, j_spec, j_g = j_local_fn(store, iso_tables, AXIS, atm, 2,
                                   profile="sdvoigt", differentiable=True,
                                   partition="weighted")
    fn, spec, g = make_od_local_fn(lines, iso, AXIS, st, 2,
                                   profile="sdvoigt", differentiable=True,
                                   partition="weighted")
    assert {c[2] for c in fn.calls} == {"full", "sdvoigt"}
    for s in range(2):
        loc = jax.tree.map(lambda a: a[s:s + 1], j_spec)
        _, want_t = jax.jvp(
            lambda T: j_fn(T, atm.p, atm.pl, atm.vmr, loc, 0), (atm.T,),
            (jnp.asarray(v),))
        want_t = np.asarray(want_t)
        _, got_t = torch.func.jvp(
            lambda T: fn(T, st.p, st.pl, st.vmr, shard_slice(spec, s), 0),
            (st.T,), (torch.as_tensor(v, dtype=torch.float32),))
        peak = np.abs(want_t).max()
        assert peak > 0.0
        assert np.abs(got_t.numpy() - want_t).max() <= TANGENT_BOUND * peak


def test_weighted_partition_balances_work(voigt):
    """The weighted partition's chunks spread a clustered list's work over
    the shards (test_dist.py's static-balance measure) and are each shard's
    tiles in ascending global order."""
    lines, iso, st = voigt["f64"]
    sub = lines.subset(lines.host["nu0"] < 830.0)   # the band's start
    axis = arange_drift_free(800.0, 920.0, 0.01)      # 12 chunks
    _, w_spec, _ = make_od_local_fn(sub, iso, axis, st, 4,
                                    partition="weighted")
    _, e_spec, _ = make_od_local_fn(sub, iso, axis, st, 4, partition="equal")

    def balance(entries):
        tot = sum(e[1].double().sum(dim=1) for e in entries)
        return float(tot.mean() / tot.max())

    assert balance(w_spec["calls"]) > 1.5 * balance(e_spec)
    for _, _, offs in w_spec["calls"]:
        tile = int(offs[0, 1] - offs[0, 0]) or 1
        first = offs + torch.arange(offs.shape[1]) * tile
        assert (first[:, 1:] > first[:, :-1]).all()


def test_sharded_lines_match_jax_and_replicated(voigt, iso_tables):
    """``make_od_sharded_lines_fn`` on 4 shards: its per-shard line sets,
    plans and gather maps integer-exact against the JAX builder's, each
    shard's OD against the JAX shard (float32), and the gathered OD against
    the replicated one-shard local builder (float64)."""
    j_fn, j_data, j_g = j_lines_fn(voigt["store"], iso_tables, AXIS,
                                   voigt["atm"], 4)
    lines, iso, st = voigt["f64"]
    fn, data, g = make_od_sharded_lines_fn(lines, iso, AXIS, st, 4)
    assert (g.x0, g.dx, g.n) == (j_g.x0, j_g.dx, j_g.n)
    for k in ("iso_row", "mol_id", "species_col"):
        np.testing.assert_array_equal(data["lines"][k].numpy(),
                                      np.asarray(j_data["lines"][k]))
    np.testing.assert_array_equal(data["lines"]["nu0"].numpy(),
                                  np.asarray(j_data["lines"]["nu0"]))
    assert len(data["calls"]) == len(j_data["calls"])
    for d, jd in zip(data["calls"], j_data["calls"]):
        for k in ("starts", "counts", "k_line", "gather"):
            np.testing.assert_array_equal(d[k].numpy(), np.asarray(jd[k]),
                                          err_msg=k)
    assert data["lines"]["nu0"].shape[1] < lines.n_lines + 1
    n_local = g.n // 4
    shards64 = [fn(st.T, st.p, st.pl, st.vmr, shard_slice(data, s),
                   s * n_local).numpy() for s in range(4)]
    ref_fn, ref_spec, ref_g = make_od_local_fn(lines, iso, AXIS, st, 1)
    n = AXIS.size
    want = ref_fn(st.T, st.p, st.pl, st.vmr, shard_slice(ref_spec, 0),
                  0).numpy()[:, :n]
    got = np.concatenate(shards64, axis=1)[:, :n]
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()

    lines, iso, st = voigt["f32"]
    fn, data, g = make_od_sharded_lines_fn(lines, iso, AXIS, st, 4)
    atm = voigt["atm"]
    peak = None
    for s in range(4):
        loc = jax.tree.map(lambda a: a[s:s + 1], j_data)
        want = np.asarray(j_fn(atm.T, atm.p, atm.pl, atm.vmr, loc,
                               s * n_local))
        got = fn(st.T, st.p, st.pl, st.vmr, shard_slice(data, s),
                 s * n_local).numpy()
        peak = peak or np.abs(want).max()
        assert np.abs(got - want).max() <= OD_BOUND * peak


def _members(st, offsets, z0_scale=1.0):
    return stack_states([dataclasses.replace(st, T=st.T + d,
                                             z0=st.z0 * z0_scale)
                         for d in offsets])


def _member(b, i):
    return AtmosphericState(**{f: getattr(b, f)[i] for f in STATE},
                            mol_ids=b.mol_ids)


def _unsharded_tud(lines, iso, g, cls, b, i, alts, **opts):
    """Member i of batch b: the port's unsharded OD on the padded grid
    (class ``cls``) composed by tud_from_od on the member's own layers."""
    x = torch.as_tensor(g.values(), dtype=lines.sw.dtype)
    m = _member(b, i)
    od = make_od_fn(lines, iso, g, cls, group_ratio=1.6,
                    far_method="classic", **opts)(m.T, m.p, m.pl, m.vmr)
    B = planckian(x, m.T).transpose(0, 1).to(od.dtype)
    return tud_from_od(x, od, B, m.z0, torch.as_tensor(alts), n_angles=6)


def _jax_od_fn(store, iso_tables, g, cls, **opts):
    """JAX's unsharded builder on the padded grid ``g`` for the class
    ``cls`` (port states), with the sharded builder's group ratio and
    far-wing method."""
    return j_od_fn(store, iso_tables, JGrid(g.x0, g.dx, g.n),
                   [_jax_state(c) for c in cls], group_ratio=1.6,
                   far_method="classic", **opts)


def _jax_tud(j_fn, g, m, alts):
    """Member m (a port state) through JAX's unsharded OD ``j_fn`` (its
    float32 kernels) and JAX's tud_from_od on the member's own layers, in
    float64."""
    jm, x = _jax_state(m), jnp.asarray(g.values())
    od = jnp.asarray(j_fn(jm.T, jm.p, jm.pl, jm.vmr), dtype=jnp.float64)
    B = jnp.swapaxes(j_planckian(x, jm.T), 0, 1)
    return j_tud_from_od(x, od, B, jm.z0, jnp.asarray(alts), n_angles=6)


def test_tud_ensemble_matches_unsharded(voigt, iso_tables):
    """``make_tud_ensemble_fn`` on a (2 x 2) virtual mesh, float64, mt_ckd:
    each member equals the unsharded OD (same envelope class and options)
    composed by tud_from_od, and lies within ``TUD_BOUND`` of JAX's
    unsharded ``make_od_pallas_fn`` (float32 kernels) + ``tud_from_od`` on
    the padded grid (measured <= 1.535e-7 of peak); the weighted partition
    equals the equal one; ``tud_ensemble_sharded`` (the reference engine)
    matches per-member compute_od_layer + tud_from_od of the port and of
    JAX in float64 (measured <= 4.993e-16 of peak against JAX)."""
    lines, iso, st = voigt["f64"]
    mesh = _cpu_mesh(2, 2)
    b = _members(st, (0.0, 4.0, -4.0, 8.0))
    env = [dataclasses.replace(st, T=st.T + d) for d in (-4.0, 8.0)]
    outs = {}
    for part in ("equal", "weighted"):
        g, run = make_tud_ensemble_fn(lines, iso, AXIS, b, ALTS, mesh,
                                      atmos_class=env, n_angles=6,
                                      continuum="mt_ckd", partition=part)
        outs[part] = run(b)
        assert outs[part][0].shape == (4, g.n, 2, 1)
        assert outs[part][2].shape == (4, g.n)
    for a, c in zip(outs["equal"], outs["weighted"]):
        np.testing.assert_array_equal(a.numpy(), c.numpy())
    worst = worst_j = 0.0
    j_fn = _jax_od_fn(voigt["store"], iso_tables, g, env, continuum="mt_ckd")
    for i in (0, 3):
        tud = _unsharded_tud(lines, iso, g, env, b, i, ALTS,
                             continuum="mt_ckd")
        j_tud = _jax_tud(j_fn, g, _member(b, i), ALTS)
        for got, want, j_want in zip(outs["equal"], (tud.tau, tud.Lu,
                                                     tud.Ld),
                                     (j_tud.tau, j_tud.Lu, j_tud.Ld)):
            worst = max(worst, _rel(got[i].numpy(), want.numpy()))
            worst_j = max(worst_j, _rel(got[i].numpy(), j_want))
    assert worst <= 1e-12, worst
    assert worst_j <= TUD_BOUND, worst_j

    grid = torch.as_tensor(AXIS[:2500])
    tau, Lu, Ld = tud_ensemble_sharded(lines, iso, grid, b, ALTS, mesh,
                                       n_angles=6, continuum="mt_ckd")
    cols = _line_species_cols(lines.host_view(), st.mol_ids)
    j_cols = jnp.asarray(j_species_cols(voigt["store"], st.mol_ids))
    j_grid = jnp.asarray(grid.numpy())
    for i in (1, 2):
        m = _member(b, i)
        od = torch.stack([compute_od_layer(lines, iso, grid, *lay, cols)
                          for lay in zip(m.T, m.p, m.pl, m.vmr)])
        od = od + continuum_od(grid, m, model="mt_ckd")
        B = planckian(grid, m.T).transpose(0, 1)
        tud = tud_from_od(grid, od, B, m.z0, torch.as_tensor(ALTS),
                          n_angles=6)
        jm = _jax_state(m)
        j_od = jnp.stack([j_od_layer(voigt["store"], iso_tables, j_grid,
                                     *lay, j_cols)
                          for lay in zip(jm.T, jm.p, jm.pl, jm.vmr)])
        j_od = j_od + j_continuum_od(j_grid, jm, model="mt_ckd")
        j_tud = j_tud_from_od(j_grid, j_od,
                              jnp.swapaxes(j_planckian(j_grid, jm.T), 0, 1),
                              jm.z0, jnp.asarray(ALTS), n_angles=6)
        for got, want, j_want in zip((tau, Lu, Ld), (tud.tau, tud.Lu,
                                                     tud.Ld),
                                     (j_tud.tau, j_tud.Lu, j_tud.Ld)):
            assert _rel(got[i].numpy(), want.numpy()) <= 1e-12
            assert _rel(got[i].numpy(), j_want) <= F64_BOUND


def test_batch_on_other_layers_is_composed_on_its_own(voigt, iso_tables):
    """A float32 ensemble (K2's plain version composes it) built on one
    batch and run on a batch whose layer grid z0 differs: each member is
    composed on its own altitudes (the same OD composed with the new z0),
    not on the build batch's (the reference's stale z0), and lies within
    ``TUD_BOUND`` of JAX's unsharded ``make_od_pallas_fn`` composed by
    JAX's K2 (``make_tud_pallas_fn``, interpret mode) on the member's own
    z0 (measured <= 8.002e-7 of peak)."""
    lines, iso, st = voigt["f32"]
    mesh = _cpu_mesh(2, 2)
    build = _members(st, (0.0, 4.0))
    other = _members(st, (0.0, 4.0), z0_scale=2.0)
    g, run = make_tud_ensemble_fn(lines, iso, AXIS, build, [0.15, 0.35],
                                  mesh, n_angles=6)
    tau, Lu, Ld = run(other)
    x = torch.as_tensor(g.values(), dtype=torch.float32)
    env = _envelope_class(build)
    j_fn = _jax_od_fn(voigt["store"], iso_tables, g, env)
    for i in range(2):
        m = _member(other, i)
        od = make_od_fn(lines, iso, g, env, group_ratio=1.6,
                        far_method="classic")(m.T, m.p, m.pl, m.vmr)
        own = make_tud_fn(m.z0.numpy(), [0.15, 0.35], n_angles=6,
                          device="cpu")(x, od, m.T)
        stale = make_tud_fn(build.z0[0].numpy(), [0.15, 0.35], n_angles=6,
                            device="cpu")(x, od, m.T)
        np.testing.assert_array_equal(Lu[i].numpy(), own.Lu.numpy())
        np.testing.assert_array_equal(tau[i].numpy(), own.tau.numpy())
        assert (own.Lu - stale.Lu).abs().max() > 1e-3 * own.Lu.abs().max()
        jm = _jax_state(m)
        j_own = j_tud_fn(np.asarray(jm.z0), np.asarray([0.15, 0.35]),
                         n_angles=6)(jnp.asarray(x.numpy()),
                                     j_fn(jm.T, jm.p, jm.pl, jm.vmr), jm.T)
        for got, want in zip((tau, Lu, Ld), (j_own.tau, j_own.Lu,
                                             j_own.Ld)):
            assert _rel(got[i].numpy(), want) <= TUD_BOUND


def _envelope_class(batch):
    from radtxfr_tpu_torch.dist.fused_ensemble import _envelope

    return _envelope(batch)


def test_tud_jacobian_matches_unsharded(voigt, iso_tables):
    """``make_tud_jacobian_fn`` on a (2 x 2) virtual mesh, float64, weighted
    partition: the primal and the tangents of 4 one-hot directions (T,
    H2O, O3) equal the unsharded ``tud_with_jacobian(engine='pallas')`` on
    the padded grid, and lie within ``TUD_BOUND`` (primal) and
    ``JAC_BOUND`` (tangents, of each one's peak) of JAX's unsharded
    ``tud_with_jacobian(engine='pallas')`` (the jvp of its builder,
    float32 kernels; measured <= 1.775e-7 and 6.067e-7)."""
    lines, iso, st = voigt["f64"]
    mesh = _cpu_mesh(2, 2)
    g, run = make_tud_jacobian_fn(lines, iso, AXIS, st, ALTS, mesh,
                                  n_angles=6, group_ratio=4.0)
    V_T, V_vmr, labels = jacobian_directions(st)
    assert V_T.shape == (3 * N_LAY, N_LAY) and len(labels) == 3 * N_LAY
    pick = [0, 3, N_LAY + 1, 2 * N_LAY + 4]
    primal, tan = run(st.T, st.vmr, V_T[pick], V_vmr[pick])
    x = torch.as_tensor(g.values())
    tud, jac = tud_with_jacobian(lines, iso, x, st, ALTS, n_angles=6,
                                 engine="pallas")
    for k in ("tau", "Lu", "Ld"):
        want = tud[k].numpy()
        assert np.abs(primal[k].numpy() - want).max() <= \
            1e-12 * np.abs(want).max()
    j_tud, j_jac = j_jacobian(voigt["store"], iso_tables,
                              jnp.asarray(x.numpy()), _jax_state(st),
                              jnp.asarray(ALTS), n_angles=6, engine="pallas")
    for k in ("tau", "Lu", "Ld"):
        assert _rel(primal[k].numpy(), j_tud[k]) <= TUD_BOUND, k
    for j, d in enumerate(pick):
        var, layer = labels[d]
        for k in ("tau", "Lu", "Ld"):
            want = jac[var][k][..., layer].numpy()
            got = tan[k][j].numpy()
            scale = max(np.abs(want).max(), 1e-300)
            assert np.abs(got - want).max() <= 1e-12 * scale, (var, k)
            assert _rel(got, np.asarray(j_jac[var][k])[..., layer]) <= \
                JAC_BOUND, (var, k)
    with pytest.raises(ValueError, match="divisible"):
        run(st.T, st.vmr, V_T[:3], V_vmr[:3])


@pytest.mark.parametrize("dtype,bound", [("f64", 1e-12), ("f32", 2e-5)])
def test_tud_jacobian_k2_composition_matches_plain(voigt, monkeypatch, dtype,
                                                   bound):
    """``make_tud_jacobian_fn`` with the differentiable K2 composition
    (what a CUDA float32 OD takes; forced here on the CPU, so its plain
    versions run) against its plain composition (``planckian`` and
    ``tud_from_od``) on a (2 x 2) virtual mesh: the primal and the tangents
    of 4 one-hot directions (T, H2O, O3), each within ``bound`` of its
    peak (float32: the plain versions' own orders of summation); nothing
    is launched."""
    from radtxfr_tpu_torch.products import tud
    from radtxfr_tpu_torch.kernels import fused_tud

    lines, iso, st = voigt[dtype]
    mesh = _cpu_mesh(2, 2)
    V_T, V_vmr, _ = jacobian_directions(st)
    pick = [0, 3, N_LAY + 1, 2 * N_LAY + 4]
    outs = []
    for k2 in (False, True):
        monkeypatch.setattr(tud, "_k2_composes",
                            lambda od, k2=k2: k2)
        _, run = make_tud_jacobian_fn(lines, iso, AXIS, st, [-1.0] + ALTS,
                                      mesh, n_angles=6, group_ratio=4.0)
        outs.append(run(st.T, st.vmr, V_T[pick], V_vmr[pick]))
    assert fused_tud.LAUNCHES["tud_jvp"] == 0
    (p0, t0), (p1, t1) = outs
    for k in ("tau", "Lu", "Ld"):
        assert _rel(p1[k].numpy(), p0[k].numpy()) <= bound, k
        assert t1[k].shape == t0[k].shape
        for j in range(len(pick)):
            assert _rel(t1[k][j].numpy(), t0[k][j].numpy()) <= bound, (k, j)


def test_make_mesh_and_helpers():
    """``make_mesh`` shapes the devices, raises with too few (and without
    a card when asked for the visible ones) and never falls back to the
    CPU; ``pad_axis_to`` and ``stack_states``."""
    mesh = _cpu_mesh(2, 4)
    assert mesh.shape == {ENSEMBLE: 2, SPECTRUM: 4}
    assert mesh.distinct() == [torch.device("cpu")]
    with pytest.raises(ValueError, match="need 16 devices, have 8"):
        make_mesh(4, 4, devices=[torch.device("cpu")] * 8)
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="need 2 devices"):
            make_mesh(1, 2)
    x = torch.arange(5.0)
    assert pad_axis_to(x, 4).tolist() == [0, 1, 2, 3, 4, 0, 0, 0]
    assert pad_axis_to(x, 5) is x


def test_make_mesh_process_pairs():
    """Without a process group the mesh of plain devices is this process's
    alone (no owner array, every entry its own, as before meshes could
    span processes); its ``(process, device)`` pairs give the same mesh
    back, now with process 0 owning every entry; a pair naming process 1
    lies outside the group of one and raises."""
    mesh = _cpu_mesh(2, 2)
    assert mesh.processes is None and not mesh.spans_group
    assert mesh.owned() == [(0, 0), (0, 1), (1, 0), (1, 1)]
    pairs = mesh.pairs()
    assert pairs == [(0, torch.device("cpu"))] * 4
    again = make_mesh(2, 2, devices=pairs)
    assert again.devices.tolist() == mesh.devices.tolist()
    assert again.processes.tolist() == [[0, 0], [0, 0]]
    assert again.owned() == mesh.owned() and not again.spans_group
    assert again.pairs() == pairs and again.shape == mesh.shape
    assert make_mesh(1, 2, devices=[(0, "cpu"), [0, "cpu"]]).pairs() == \
        pairs[:2]
    with pytest.raises(ValueError, match="process 1 is outside the group "
                                         "of 1"):
        make_mesh(1, 2, devices=[(0, "cpu"), (1, "cpu")])


TUD_CLI = ["tud", "--derived", "--line-mixing", "--continuum", "mt_ckd",
           "--numin", "790", "--numax", "792", "--dv", "0.005", "--n-atmos",
           "3", "--batch", "2", "--n-angles", "8", "--altitudes", "0.35",
           "500"]


def _tud_args(extra):
    return build_parser().parse_args(TUD_CLI + ["--device", "cpu"] + extra)


def _jax_cli(extra, path):
    """The JAX CLI's single-device ``tud`` (its Pallas engine in interpret
    mode, float32 as on its chip): the HDF5 products, ``La`` as ``Lu``."""
    import h5py

    args = j_build_parser().parse_args(TUD_CLI + extra + [
        "--engine", "pallas", "--output", path])
    jax.config.update("jax_enable_x64", False)
    try:
        args.fn(args)
    finally:
        jax.config.update("jax_enable_x64", True)
    with h5py.File(path, "r") as f:
        return {("Lu" if k == "La" else k): f[k][...] for k in f
                if k not in ("X", "Altitudes")}


@pytest.fixture
def six_layers(monkeypatch):
    """``tud``'s standard atmosphere, the port's and the JAX package's, cut
    to its first six layers (the sensor altitudes above them), for CPU run
    times of seconds."""
    from radtxfr_tpu_torch.atmos import profile

    full, j_full = profile.std_atmosphere, j_atmos.std_atmosphere
    monkeypatch.setattr(profile, "std_atmosphere", lambda **kw: (
        lambda a: dataclasses.replace(a, **{f: getattr(a, f)[:6]
                                            for f in STATE}))(full(**kw)))
    monkeypatch.setattr(j_atmos, "std_atmosphere", lambda **kw: (
        lambda a: a.replace(**{f: getattr(a, f)[:6]
                               for f in STATE}))(j_full(**kw)))


@pytest.mark.parametrize("with_options", [False, True])
def test_cli_mesh_matches_single_device(tmp_path, six_layers, with_options):
    """``tud --mesh-spectrum 2 --mesh-ensemble 2`` on a virtual CPU mesh
    (passed through ``run_tud``) against the single-device ``run_tud``
    (float32, the plain versions), without and with ``--checkpoint`` and
    ``--jacobian``, on the 790 cm^-1 CO2 Q branch (line mixing, mt_ckd).
    The sharded run sizes its plans on the envelope of each batch (the
    single-device run on the base state, whose wing bound clamps the
    perturbed members' wings), groups layers by 1.6 (there 4.0) and pads
    the grid, so the two agree to the float32 kernel bound of each
    product's peak (test_torch_cli.py's, 1e-5; measured here <= 8.2e-8 in
    the products and 1.9e-7 in the Jacobians; at production width the gap
    is chip_smoke.py phase 12's mesh-vs-phase-5 reading). The sharded
    products and Jacobians are also held to the JAX CLI's single-device
    run with ``--checkpoint`` and ``--jacobian`` (its Pallas engine,
    float32) at test_torch_cli.py's bounds: 1e-5 of each product's peak,
    5e-4 of each Jacobian's (measured <= 2.435e-7 of peak, Jacobians
    included). A restarted checkpointed run reads its batches back: the
    same products, bit for bit."""
    extra = []
    if with_options:
        extra = ["--checkpoint", str(tmp_path / "ck"), "--jacobian",
                 "--jacobian-wrt", "T"]
    mesh_args = ["--mesh-spectrum", "2", "--mesh-ensemble", "2"]
    x0, single = run_tud(_tud_args(extra), "cpu")
    x1, sharded = run_tud(_tud_args(extra + mesh_args), "cpu",
                          mesh=_cpu_mesh(2, 2))
    np.testing.assert_allclose(x1, x0, rtol=1e-12)
    assert set(sharded) == set(single)
    for k, want in single.items():
        got = sharded[k]
        assert got.shape == want.shape, k
        assert np.isfinite(got).all(), k
        peak = np.abs(want).max()
        assert peak > 0.0, k
        assert np.abs(got - want).max() <= 1e-5 * peak, k
    if with_options:
        j_single = _jax_cli(["--checkpoint", str(tmp_path / "j_ck")]
                            + extra[2:], str(tmp_path / "jax.h5"))
        assert set(j_single) == set(sharded)
        for k, want in j_single.items():
            assert sharded[k].shape == want.shape, k
            assert _rel(sharded[k], want) <= (5e-4 if k.startswith("d")
                                              else 1e-5), k
    if with_options:
        assert sorted(os.listdir(tmp_path / "ck"))[:2] == [
            "batch_000000.npz", "batch_000001.npz"]
        _, again = run_tud(_tud_args(extra[:2] + mesh_args), "cpu",
                           mesh=_cpu_mesh(2, 2))
        for k in ("tau", "Lu", "Ld"):
            np.testing.assert_array_equal(again[k], sharded[k])
    else:
        with pytest.raises(ValueError, match="mesh"):
            run_tud(_tud_args(mesh_args), "cpu", mesh=_cpu_mesh(1, 2))
        with pytest.raises(SystemExit):
            run_tud(_tud_args(mesh_args + ["--batch", "3"]), "cpu",
                    mesh=_cpu_mesh(2, 2))


_WORKER = """
import sys
import torch
from radtxfr_tpu_torch.dist.init import init_multihost, runtime_info
from radtxfr_tpu_torch.dist.checkpoint import host_gather

coord, pid = sys.argv[1], int(sys.argv[2])
init_multihost(coordinator_address=coord, num_processes=2, process_id=pid)
info = runtime_info()
assert info["process_count"] == 2 and info["process_index"] == pid, info
x = torch.arange(4.0) + 10.0 * pid
h = host_gather(x)
assert h.shape == (8,) and h.tolist() == [0, 1, 2, 3, 10, 11, 12, 13], h
torch.distributed.destroy_process_group()
assert host_gather(x).tolist() == x.tolist()
print("WORKER_OK", pid)
"""


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_init_and_host_gather(tmp_path):
    """``init_multihost`` joins two CPU processes into one gloo group
    (JAX's coordinator/process arguments), ``runtime_info`` reports it,
    and ``host_gather`` all-gathers each process's piece (the identity once
    the group is gone), as tests/test_dist_infra.py checks for JAX."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ)
    env["PYTHONPATH"] = (os.path.dirname(os.path.dirname(__file__))
                         + os.pathsep + env.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, coord, str(i)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=str(tmp_path))
             for i in (0, 1)]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=120)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{out}"
        assert f"WORKER_OK {i}" in out, out
