"""The port's sharded path on a mesh that spans two processes (the
counterpart of JAX's multi-controller ``shard_map`` over a global mesh).

Two child processes join one gloo group (``init_multihost`` on a free
local port, one torch thread each, no JAX imported) and run, in float64 at
``tests/test_torch_dist.py``'s sizes, on CPU meshes named as ``(process,
device)`` pairs: the fused ensemble with both partitions and the sharded
Jacobian on a (2 x 2) mesh whose ensemble row e belongs to process e, the
reference engine's ``tud_ensemble_sharded`` on the same mesh, the fused
ensemble on an uneven (1 x 3) mesh (process 0 owns two entries, process 1
one), builds whose plans differ between the processes, meshes that name a
process outside the group or too few devices, and ``run_tiled`` with each
process writing its own shard into one directory. Each process writes what
it received. The parent, meanwhile, computes the one-process meshes'
results and JAX's.

Every process's copy of each result is bit-identical to the one-process
mesh's (the parts move through the group as they are). The reference
engine's is within ``F64_BOUND`` (1e-12 of peak) of JAX's unsharded
``compute_od_layer`` + ``tud_from_od`` in float64; the fused ensemble and
the Jacobian are within ``TUD_BOUND`` / ``JAC_BOUND`` of JAX's unsharded
Pallas path, whose kernels compute in float32 whatever the inputs
(``tests/test_torch_dist.py`` holds the one-process mesh to the port's
unsharded float64 path at 1e-12).
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from radtxfr_tpu.dist import checkpoint as j_ck
from radtxfr_tpu.products.jacobian import tud_with_jacobian as j_jacobian
from radtxfr_tpu_torch.dist import tud_ensemble_sharded
from radtxfr_tpu_torch.dist.fused_ensemble import (jacobian_directions,
                                                   make_tud_ensemble_fn,
                                                   make_tud_jacobian_fn)
from port_fixtures import one_torch_thread  # noqa: F401
from test_torch_dist import (ALTS, AXIS, F64_BOUND, FIELDS, JAC_BOUND,
                             N_LAY, STATE, TUD_BOUND, _atm, _boundary_lines,
                             _cpu_mesh, _free_port, _jax_od_fn, _jax_state,
                             _jax_tud, _member, _members, _port, _rel)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CHILD_TIMEOUT = 120
#: the members' temperature offsets (K) and the Jacobian's directions
#: (T at layers 0 and 3, H2O at 1, O3 at 4)
OFFSETS = (0.0, 4.0, -4.0, 8.0)
PICK = [0, 3, N_LAY + 1, 2 * N_LAY + 4]
#: the reference engine's grid: a multiple of both meshes' spectrum axes
REF_POINTS = 2496
TILED = dict(n_items=7, batch_size=3, n_shards=2)
ISO_FIELDS = ("q", "abundance", "molar_mass", "mol", "iso")

_CHILD = r'''
import json, os, sys
import numpy as np
import torch
torch.set_num_threads(1)
from radtxfr_tpu_torch.atmos.profile import AtmosphericState
from radtxfr_tpu_torch.dist import (make_mesh, stack_states,
                                    tud_ensemble_sharded)
from radtxfr_tpu_torch.dist import checkpoint as ck
from radtxfr_tpu_torch.dist.fused_ensemble import (
    jacobian_directions, make_tud_ensemble_fn, make_tud_jacobian_fn)
from radtxfr_tpu_torch.dist.init import init_multihost, runtime_info
from radtxfr_tpu_torch.lines.store import IsoTables, LineStore
import dataclasses
import torch.distributed as dist

coord, rank, work = sys.argv[1], int(sys.argv[2]), sys.argv[3]
cfg = json.loads(sys.argv[4])
init_multihost(coordinator_address=coord, num_processes=2, process_id=rank)
assert "jax" not in sys.modules and "radtxfr_tpu" not in sys.modules
assert runtime_info()["process_count"] == 2
f64, cpu = torch.float64, torch.device("cpu")
with np.load(os.path.join(work, "inputs.npz")) as f:
    a = {k: f[k] for k in f.files}
lines = LineStore.from_numpy(**{k: a["line_" + k] for k in cfg["fields"]},
                             device="cpu", dtype=f64)
iso = IsoTables.from_numpy(**{k: a["iso_" + k] for k in cfg["iso_fields"]},
                           device="cpu", dtype=f64)
st = AtmosphericState.from_numpy(**{k: a["atm_" + k] for k in cfg["state"]},
                                 mol_ids=tuple(cfg["mol_ids"]), device="cpu",
                                 dtype=f64)
axis, alts = a["axis"], cfg["alts"]
b = stack_states([dataclasses.replace(st, T=st.T + d)
                  for d in cfg["offsets"]])
env = [dataclasses.replace(st, T=st.T + d) for d in (-4.0, 8.0)]
out, msgs = {}, {}
rows = make_mesh(2, 2, devices=[(0, cpu), (0, cpu), (1, cpu), (1, cpu)])
msgs["owned"] = rows.owned()
msgs["processes"] = rows.processes.tolist()

for part in ("equal", "weighted"):
    g, run = make_tud_ensemble_fn(lines, iso, axis, b, alts, rows,
                                  atmos_class=env, n_angles=6,
                                  continuum="mt_ckd", partition=part)
    for k, v in zip(("tau", "Lu", "Ld"), run(b)):
        out[f"ens_{part}_{k}"] = v.numpy()

g, run_j = make_tud_jacobian_fn(lines, iso, axis, st, alts, rows,
                                n_angles=6, group_ratio=4.0)
V_T, V_vmr, _ = jacobian_directions(st)
prim, tan = run_j(st.T, st.vmr, V_T[cfg["pick"]], V_vmr[cfg["pick"]])
for k in ("tau", "Lu", "Ld"):
    out["jac_primal_" + k] = prim[k].numpy()
    out["jac_tangent_" + k] = tan[k].numpy()

grid = torch.as_tensor(axis[:cfg["ref_points"]])
for k, v in zip(("tau", "Lu", "Ld"), tud_ensemble_sharded(
        lines, iso, grid, b, alts, rows, n_angles=6, continuum="mt_ckd")):
    out["ref_" + k] = v.numpy()

uneven = make_mesh(1, 3, devices=[(0, cpu), (0, cpu), (1, cpu)])
msgs["uneven_owned"] = uneven.owned()
b2 = stack_states([dataclasses.replace(st, T=st.T + d) for d in (0.0, 4.0)])
g, run = make_tud_ensemble_fn(lines, iso, axis, b2, alts, uneven,
                              atmos_class=env, n_angles=6)
for k, v in zip(("tau", "Lu", "Ld"), run(b2)):
    out["uneven_" + k] = v.numpy()

# plans built from other inputs in each process: both raise, neither hangs
try:
    make_tud_ensemble_fn(lines, iso, axis, b2, alts, rows,
                         atmos_class=env, n_angles=6,
                         wing_hw=50.0 if rank == 0 else 25.0)
    msgs["mismatch"] = None
except ValueError as e:
    msgs["mismatch"] = str(e)
for name, args in (("outside", ((1, 2), [(0, cpu), (2, cpu)])),
                   ("mixed", ((1, 2), [(0, cpu), cpu])),
                   ("default", ((2, 1), None))):
    try:
        make_mesh(*args[0], devices=args[1])
        msgs[name] = None
    except ValueError as e:
        msgs[name] = str(e)

def compute(indices, shard):
    rng = np.random.default_rng(1000 + 10 * int(indices[0]) + shard)
    return {"tau": rng.random((len(indices), 5, 2)).astype(np.float32),
            "idx": np.asarray(indices)}

t = cfg["tiled"]
tiled = ck.TiledCheckpoint(os.path.join(work, "tiles"), t["n_items"],
                           t["batch_size"], t["n_shards"])
logs = []
first = ck.run_tiled(tiled, compute, log=logs.append, owned_shards=[rank])
dist.barrier()
msgs["tiled_logs"] = logs
msgs["tiled_first_none"] = first is None
for k, v in tiled.gather().items():
    out["tiled_" + k] = v

np.savez(os.path.join(work, f"rank{rank}.npz"), **out)
with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
    json.dump(msgs, f)
dist.destroy_process_group()
print("CHILD_OK", rank)
'''


def _compute_tile(indices, shard):
    """The children's tile function (``_CHILD``'s ``compute``)."""
    rng = np.random.default_rng(1000 + 10 * int(indices[0]) + shard)
    return {"tau": rng.random((len(indices), 5, 2)).astype(np.float32),
            "idx": np.asarray(indices)}


@pytest.fixture(scope="module")
def case(iso_tables, tmp_path_factory):
    """The inputs (150 synthetic lines with strong ones on the shard edges,
    five layers, the port's float64 copies), the two children started on
    them and the parent's one-process results computed while they run;
    then each child's results (both must exit 0 within CHILD_TIMEOUT)."""
    work = tmp_path_factory.mktemp("two_processes")
    store, atm = _boundary_lines(150, 33, sd_zero_frac=1.0), _atm()
    lines, iso, st = _port(store, iso_tables, atm, torch.float64)
    # the host arrays _port converts, for the children's from_numpy
    hv, j_iso = jax.device_get(store), jax.device_get(iso_tables)
    arrays = {"axis": AXIS}
    arrays.update({"line_" + k: np.asarray(getattr(hv, k)) for k in FIELDS})
    arrays.update({"iso_" + k: np.asarray(getattr(j_iso, k))
                   for k in ISO_FIELDS})
    arrays.update({"atm_" + k: np.asarray(getattr(atm, k)) for k in STATE})
    np.savez(work / "inputs.npz", **arrays)
    cfg = dict(fields=FIELDS, iso_fields=ISO_FIELDS, state=STATE,
               mol_ids=list(st.mol_ids), alts=ALTS, offsets=OFFSETS,
               pick=PICK, ref_points=REF_POINTS, tiled=TILED)
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    coord = f"127.0.0.1:{_free_port()}"
    procs = [subprocess.Popen([sys.executable, "-c", _CHILD, coord, str(r),
                               str(work), json.dumps(cfg)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, cwd=str(work))
             for r in (0, 1)]
    try:
        b = _members(st, OFFSETS)
        envl = [dataclasses.replace(st, T=st.T + d) for d in (-4.0, 8.0)]
        one = {}
        for part in ("equal", "weighted"):
            g, run = make_tud_ensemble_fn(lines, iso, AXIS, b, ALTS,
                                          _cpu_mesh(2, 2), atmos_class=envl,
                                          n_angles=6, continuum="mt_ckd",
                                          partition=part)
            one["ens_" + part] = run(b)
        gj, run_j = make_tud_jacobian_fn(lines, iso, AXIS, st, ALTS,
                                         _cpu_mesh(2, 2), n_angles=6,
                                         group_ratio=4.0)
        V_T, V_vmr, labels = jacobian_directions(st)
        one["jac"] = run_j(st.T, st.vmr, V_T[PICK], V_vmr[PICK])
        grid = torch.as_tensor(AXIS[:REF_POINTS])
        one["ref"] = tud_ensemble_sharded(lines, iso, grid, b, ALTS,
                                          _cpu_mesh(2, 2), n_angles=6,
                                          continuum="mt_ckd")
        b2 = _members(st, (0.0, 4.0))
        gu, run_u = make_tud_ensemble_fn(lines, iso, AXIS, b2, ALTS,
                                         _cpu_mesh(1, 3), atmos_class=envl,
                                         n_angles=6)
        one["uneven"] = run_u(b2)
        outs = []
        for p in procs:
            out, _ = p.communicate(timeout=CHILD_TIMEOUT)
            outs.append(out.decode(errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"child {r} failed:\n{out}"
        assert f"CHILD_OK {r}" in out, out
    got = []
    for r in (0, 1):
        with np.load(work / f"rank{r}.npz") as f:
            arrs = {k: f[k] for k in f.files}
        with open(work / f"rank{r}.json") as f:
            got.append((arrs, json.load(f)))
    return dict(store=store, atm=atm, lines=lines, iso=iso, st=st, b=b,
                env=envl, one=one, got=got, g=g, gj=gj, labels=labels,
                work=work)


def _same(got, want):
    np.testing.assert_array_equal(got, want.numpy())
    assert got.dtype == np.float64


def test_mesh_rows_belong_to_their_processes(case):
    """``make_mesh`` over (process, device) pairs in a group of two: the
    (2 x 2) mesh's row e belongs to process e, the (1 x 3) mesh's first
    two entries to process 0; each process lists only its own entries."""
    for r, (_, msgs) in enumerate(case["got"]):
        assert msgs["processes"] == [[0, 0], [1, 1]]
        assert [tuple(e) for e in msgs["owned"]] == [(r, 0), (r, 1)]
        assert [tuple(e) for e in msgs["uneven_owned"]] == (
            [(0, 0), (0, 1)] if r == 0 else [(0, 2)])


@pytest.mark.parametrize("part", ["equal", "weighted"])
def test_two_process_ensemble_is_the_one_process_mesh(case, iso_tables,
                                                      part):
    """``make_tud_ensemble_fn`` on the (2 x 2) mesh over two processes:
    each process's gathered tau/Lu/Ld equal the one-process mesh's bit for
    bit, and member 3 lies within ``TUD_BOUND`` of JAX's unsharded
    ``make_od_pallas_fn`` (float32 kernels) + ``tud_from_od`` on the padded
    grid."""
    want = case["one"]["ens_" + part]
    for arrs, _ in case["got"]:
        for k, w in zip(("tau", "Lu", "Ld"), want):
            _same(arrs[f"ens_{part}_{k}"], w)
    j_fn = _jax_od_fn(case["store"], iso_tables, case["g"], case["env"],
                      continuum="mt_ckd")
    j_tud = _jax_tud(j_fn, case["g"], _member(case["b"], 3), ALTS)
    arrs = case["got"][1][0]
    for k, j_want in zip(("tau", "Lu", "Ld"),
                         (j_tud.tau, j_tud.Lu, j_tud.Ld)):
        assert _rel(arrs[f"ens_{part}_{k}"][3], j_want) <= TUD_BOUND, k


def test_two_process_jacobian_is_the_one_process_mesh(case, iso_tables):
    """``make_tud_jacobian_fn`` on the (2 x 2) mesh over two processes (the
    directions split over the processes, the primal from the owner of row
    0): each process's primal and tangents equal the one-process mesh's bit
    for bit, and lie within ``TUD_BOUND`` (primal) and ``JAC_BOUND``
    (tangents, of each one's peak) of JAX's unsharded
    ``tud_with_jacobian(engine='pallas')``."""
    primal, tan = case["one"]["jac"]
    for arrs, _ in case["got"]:
        for k in ("tau", "Lu", "Ld"):
            _same(arrs["jac_primal_" + k], primal[k])
            _same(arrs["jac_tangent_" + k], tan[k])
    x = jnp.asarray(case["gj"].values())
    j_tud, j_jac = j_jacobian(case["store"], iso_tables, x,
                              _jax_state(case["st"]), jnp.asarray(ALTS),
                              n_angles=6, engine="pallas")
    arrs = case["got"][0][0]
    for k in ("tau", "Lu", "Ld"):
        assert _rel(arrs["jac_primal_" + k], j_tud[k]) <= TUD_BOUND, k
        for j, d in enumerate(PICK):
            var, layer = case["labels"][d]
            want = np.asarray(j_jac[var][k])[..., layer]
            assert _rel(arrs["jac_tangent_" + k][j], want) <= JAC_BOUND, \
                (var, k)


def test_two_process_reference_engine_is_the_one_process_mesh(case,
                                                               iso_tables):
    """``tud_ensemble_sharded`` (the reference engine) on the (2 x 2) mesh
    over two processes: bit-identical to the one-process mesh in each
    process, and within ``F64_BOUND`` of JAX's ``compute_od_layer`` +
    ``continuum_od`` + ``tud_from_od`` per member in float64."""
    from radtxfr_tpu.atmos.continuum import continuum_od as j_continuum_od
    from radtxfr_tpu.core.planck import planckian as j_planckian
    from radtxfr_tpu.products.od import _line_species_cols as j_cols_of
    from radtxfr_tpu.products.od import compute_od_layer as j_od_layer
    from radtxfr_tpu.products.tud import tud_from_od as j_tud_from_od

    for arrs, _ in case["got"]:
        for k, w in zip(("tau", "Lu", "Ld"), case["one"]["ref"]):
            _same(arrs["ref_" + k], w)
    store = case["store"]
    j_grid = jnp.asarray(AXIS[:REF_POINTS])
    j_cols = jnp.asarray(j_cols_of(store, case["st"].mol_ids))
    arrs = case["got"][1][0]
    for i in (0, 3):
        jm = _jax_state(_member(case["b"], i))
        od = jnp.stack([j_od_layer(store, iso_tables, j_grid, *lay, j_cols)
                        for lay in zip(jm.T, jm.p, jm.pl, jm.vmr)])
        od = od + j_continuum_od(j_grid, jm, model="mt_ckd")
        j_tud = j_tud_from_od(j_grid, od,
                              jnp.swapaxes(j_planckian(j_grid, jm.T), 0, 1),
                              jm.z0, jnp.asarray(ALTS), n_angles=6)
        for k, j_want in zip(("tau", "Lu", "Ld"),
                             (j_tud.tau, j_tud.Lu, j_tud.Ld)):
            assert _rel(arrs["ref_" + k][i], j_want) <= F64_BOUND, (i, k)


def test_uneven_two_process_mesh_is_the_one_process_mesh(case):
    """A (1 x 3) mesh whose process 0 owns two entries and process 1 one:
    each process's gathered ensemble equals the one-process (1 x 3) mesh's
    bit for bit."""
    for arrs, _ in case["got"]:
        for k, w in zip(("tau", "Lu", "Ld"), case["one"]["uneven"]):
            _same(arrs["uneven_" + k], w)


def test_two_process_faults_raise(case):
    """No fallback: plans built from other inputs in each process raise in
    both (neither is left waiting); a mesh naming process 2 of a group of
    two, one mixing pairs with plain devices, and the default global mesh
    on processes without a card raise."""
    for _, msgs in case["got"]:
        assert "different plans" in msgs["mismatch"], msgs["mismatch"]
        assert msgs["outside"] == ("process 2 is outside the group of 2 "
                                   "process(es)")
        assert "(process, device) pair" in msgs["mixed"]
        assert msgs["default"] == "need 2 devices, have 0"


def test_two_writers_run_tiled_into_one_directory(case, tmp_path):
    """``run_tiled(owned_shards=[rank])`` in each of the two processes
    writes that process's shard of every batch into one directory and
    returns None or the whole; after a barrier both ``gather`` the whole,
    equal to one process's ``run_tiled`` over every shard and to JAX's."""
    for r, (_, msgs) in enumerate(case["got"]):
        assert len(msgs["tiled_logs"]) == 3
        assert all(f"shard {r})" in line for line in msgs["tiled_logs"])
    assert not (case["got"][0][1]["tiled_first_none"]
                and case["got"][1][1]["tiled_first_none"])
    one = j_ck.run_tiled(j_ck.TiledCheckpoint(str(tmp_path / "jax"),
                                              **TILED), _compute_tile,
                         log=None)
    names = sorted(f for f in os.listdir(case["work"] / "tiles")
                   if ".tmp." not in f)
    assert names == sorted(["manifest.json"] + [
        f"tile_{b:06d}_{s:03d}.npz" for b in range(3) for s in range(2)])
    for arrs, _ in case["got"]:
        for k, want in one.items():
            got = arrs["tiled_" + k]
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
