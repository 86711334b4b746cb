"""Driver: serving TUD members from a cross-section table (the fast path
of scene and retrieval users: ``products/od_from_xs.py``).

Set-up makes the table from the seed on the card (an ``XsTable`` of the
configuration's molecules, T and p lattice and axis: smooth log-normal
cross-sections whose layer ODs span the lattice's range) and hands it to
the program as a loaded table. A request is one perturbed atmosphere (the
ensemble's draw rule): ``od_from_xs`` (the corner-weight matrix and one
product), ``tud_fn`` (K2), the banded reduction of tau and Lu at every
sensor altitude and of Ld, and the copy to the host. Spans: ``request``,
``od``, ``tud``, ``reduce``, ``copy``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchkit import checks
from benchkit import work as yardstick
from benchkit.harness import Record, rng_for
from benchkit.inputs.atmosphere import (N_DRAWS, Atmosphere, ensemble_draws,
                                        member, member_tensors)
from benchkit.inputs.grid import axis
from benchkit.reference.radiative import Reduction, table_od
from benchkit.tracing import span

@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    table: object
    tud_fn: object
    op: object
    grid: torch.Tensor
    base: object
    draws: tuple
    X: np.ndarray
    n_out: int
    plan_build_s: float
    precision: str = "highest"
    fault: str | None = None
    members_per_request: int = 1
    phases: dict = dataclasses.field(default_factory=dict)


def lattice(cfg):
    T = np.arange(cfg["T_min"], cfg["T_max"] + 1e-9, cfg["T_step"])
    p = np.arange(cfg["p_min_atm"], cfg["p_max_atm"] + 1e-9,
                  cfg["p_step_atm"])
    return T, p


def make_table(cfg, seed, n_x, device):
    """(nM, nT, nP, nX) float32 cross-sections [cm^2/molec] from the seed:
    log10 sigma = a_m + 1.5 u + alpha log(T/296) + 0.3 log(p), u and alpha
    smooth standard-normal fields (256-point knots, linear between)."""
    T, p = lattice(cfg)
    mols = cfg["lines"]["molecules"]
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([int(seed), 5]).generate_state(
        1)[0]))
    knots = n_x // 256 + 2

    def field():
        k = torch.randn((len(mols), 1, knots), generator=g, device=device)
        return torch.nn.functional.interpolate(
            k, size=n_x, mode="linear", align_corners=True)[:, 0]

    a = torch.as_tensor([cfg["serve"]["log10_sigma"][str(m)] for m in mols],
                        dtype=torch.float32, device=device)[:, None]
    base = a + 1.5 * field()                                   # (nM, nX)
    alpha = field()
    lt = torch.as_tensor(np.log(T / 296.0), dtype=torch.float32,
                         device=device)
    lp = torch.as_tensor(np.log(p), dtype=torch.float32, device=device)
    ln10 = float(np.log(10.0))
    return torch.exp(ln10 * base[:, None, None, :]
                     + alpha[:, None, None, :] * lt[None, :, None, None]
                     + 0.3 * lp[None, None, :, None])


def setup(cell, seed, device, control=None, fault=None):
    from radtxfr_tpu_torch.atmos.profile import AtmosphericState
    from radtxfr_tpu_torch.products.od_from_xs import XsTable
    from radtxfr_tpu_torch.products.tud import make_tud_fn
    from radtxfr_tpu_torch.sensor.resolution import reduce_operator

    cfg, traffic = cell.config, cell.traffic
    t_in = time.perf_counter()
    sv = cfg["serve"]
    band = cfg["band"]
    X = axis(band["numin"], band["numax"], band["dv"])
    T, p = lattice(cfg)
    f32 = torch.float32
    table = XsTable(sigma=make_table(cfg, seed, X.size, device),
                    T_grid=torch.as_tensor(T, dtype=f32, device=device),
                    logp_grid=torch.as_tensor(np.log(p), dtype=f32,
                                              device=device),
                    x=X, mol_ids=tuple(cfg["lines"]["molecules"]))
    a = Atmosphere.standard()
    base = AtmosphericState.from_numpy(z0=a.z0, z1=a.z1, pl=a.pl, p=a.p,
                                       T=a.T, vmr=a.vmr, mol_ids=a.mol_ids,
                                       device=device, dtype=f32)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    phases = {"table": t0 - t_in}
    tud_fn = make_tud_fn(a.z0, sv["altitudes_km"], n_angles=sv["n_angles"],
                         device=device)
    op = reduce_operator(X, sv["dv_out"], device=device)
    build = time.perf_counter() - t0
    st = State(cfg=cfg, traffic=traffic, seed=seed, device=device,
               table=table, tud_fn=tud_fn, op=op,
               grid=torch.as_tensor(X, dtype=f32, device=device), base=base,
               draws=ensemble_draws(N_DRAWS, seed), X=X,
               n_out=int(op.n_out), plan_build_s=build,
               precision="default" if control == "program" else "highest",
               fault=fault, phases=phases)
    phases["plans"] = build
    t0 = time.perf_counter()
    for i in range(int(traffic.get("warmup_requests", 3))):
        request(st, -1 - i)
    phases["warm_up"] = time.perf_counter() - t0
    return st


def request(st, i):
    from radtxfr_tpu_torch.products.od_from_xs import od_from_xs

    k = i % N_DRAWS
    with span("request"):
        T, vmr = member_tensors(st.base.T, st.base.vmr, st.draws, k)
        atmos = dataclasses.replace(st.base, T=T, vmr=vmr)
        with span("od"):
            od = od_from_xs(st.table, atmos, precision=st.precision)
        if st.fault == "answer":
            od = od * (1.0 + 1e-2)
        with span("tud"):
            tud = st.tud_fn(st.grid, od, T)
        with span("reduce"):
            red = [st.op(a) for a in (tud.tau[:, :, 0], tud.Lu[:, :, 0],
                                      tud.Ld)]
        with span("copy"):
            out = [a.cpu().numpy() for a in red]
    if i < 0:
        return Record(units=1)
    idx = checks.outputs(rng_for(st.seed, 17, i), st.n_out,
                         int(st.traffic["check_outputs"]))
    return Record(units=1, sample=(k, idx, out[0][idx], out[1][idx],
                                   out[2][idx]))


def work(st, indices):
    """The traced members' least times: the table lookup as a product
    (:func:`~benchkit.work.table_od_work`) and K2."""
    n_m, n_t, n_p, n_x = st.table.sigma.shape
    n_l = int(st.base.T.numel())
    t_xs, by_xs = yardstick.bound(*yardstick.table_od_work(
        n_l, n_m * n_t * n_p, n_x))
    sv = st.cfg["serve"]
    ops, nbytes, sfu = yardstick.k2_work(n_x, n_l, len(sv["altitudes_km"]),
                                         1, sv["n_angles"])
    t_k2, by_k2 = yardstick.bound(ops, nbytes, sfu)
    n = len(indices)
    return {"xs_bound_s": n * t_xs, "xs_bound_by": [by_xs],
            "k2_bound_s": n * t_k2, "k2_bound_by": [by_k2]}


def release(st, samples):
    """What the check needs: the table's columns at every fine point the
    sampled outputs read, in float64 (the table is the benchmark's input),
    and the draws; the program's state is dropped."""
    red = Reduction(st.X, st.cfg["serve"]["dv_out"])
    cols = {}
    for k, idx, *_ in samples.values():
        for o in idx:
            lo, hi = red.support(int(o))
            cols[(lo, hi)] = st.table.sigma[..., lo:hi].double().cpu()
    return {"cfg": st.cfg, "X": st.X, "draws": st.draws, "cols": cols,
            "T_grid": st.table.T_grid.double().cpu().numpy(),
            "logp_grid": st.table.logp_grid.double().cpu().numpy(),
            "mol_ids": st.table.mol_ids, "n_out": st.n_out,
            "limits": st.traffic["limits"], "device": st.device}


def check(ref, samples, control_dtype=None):
    cfg, X, dev = ref["cfg"], ref["X"], ref["device"]
    sv = cfg["serve"]
    red = Reduction(X, sv["dv_out"])
    if red.n_out != ref["n_out"]:
        return [("n_out_mismatch", float("inf"), 0.0)]
    a = Atmosphere.standard()
    col = {m: i for i, m in enumerate(a.mol_ids)}
    mcols = [col[m] for m in ref["mol_ids"]]
    T_grid, logp_grid = ref["T_grid"], ref["logp_grid"]

    def reference(k, idx, dtype):
        m = member(a, ref["draws"], k)

        def od_at(pts, lo):
            s = ref["cols"][(lo, lo + pts.size)].to(device=dev, dtype=dtype)
            return table_od(s, T_grid, logp_grid, m.T, m.p, m.pl,
                            m.vmr[:, mcols])

        return checks.member_reference(red, idx, X, od_at, m.T, a.z0,
                                       sv["altitudes_km"], sv["n_angles"],
                                       dtype, dev)

    prog, refs = [], []
    for i in sorted(samples):
        k, idx, tau, Lu, Ld = samples[i]
        refs.append(reference(k, idx, torch.float64))
        prog.append((tau, Lu, Ld) if control_dtype is None
                    else reference(k, idx, control_dtype))
    if not refs:
        return []
    return checks.with_limits(checks.compare(prog, refs), ref["limits"])
