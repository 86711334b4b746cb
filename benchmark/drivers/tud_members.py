"""Driver: TUD ensembles, the production job (``cli/main.py::run_tud``'s
``compute_batch`` on the kernels).

A request is ``members_per_request`` perturbed atmospheres (the CLI's draw
rule from the seed, member after member): each through ``od_fn`` (line
parameters, the K1 passes, the continuum), ``tud_fn`` (K2) and the banded
reduction of tau and Lu at every sensor altitude and of Ld, then the
request's products stacked and copied to the host. Spans: ``request``,
``member``, ``od``, ``tud``, ``reduce``, ``copy``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchkit import checks, lwir
from benchkit import work as yardstick
from benchkit.harness import Record, rng_for
from benchkit.inputs.atmosphere import (N_DRAWS, Atmosphere, ensemble_draws,
                                        member, member_tensors)
from benchkit.reference import lbl
from benchkit.reference.continuum import mt_ckd_od
from benchkit.reference.radiative import Reduction
from benchkit.tracing import span

@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    od_fn: object
    tud_fn: object
    op: object
    grid: torch.Tensor
    base: object
    draws: tuple
    X: np.ndarray
    cols: dict
    y_air: np.ndarray
    n_out: int
    plan_build_s: float
    members_per_request: int
    fault: str | None = None
    phases: dict = dataclasses.field(default_factory=dict)


def setup(cell, seed, device, control=None, fault=None):
    from radtxfr_tpu_torch.atmos.profile import AtmosphericState
    from radtxfr_tpu_torch.lines.store import IsoTables, from_arrays
    from radtxfr_tpu_torch.products.od import make_od_fn
    from radtxfr_tpu_torch.products.tud import make_tud_fn
    from radtxfr_tpu_torch.sensor.resolution import reduce_operator

    cfg, traffic = cell.config, cell.traffic
    t_in = time.perf_counter()
    cols, X, y = lwir.inputs(cfg)
    f32 = torch.float32
    store = from_arrays(cols["nu0"], cols["sw"], cols["elower"],
                        cols["gamma_air"], cols["gamma_self"], cols["n_air"],
                        cols["delta_air"], cols["mol_id"],
                        cols["local_iso_id"], sd_air=cols["sd_air"],
                        dtype=f32, device=device)
    iso = IsoTables.load(dtype=f32, device=device)
    a = Atmosphere.standard()
    base = AtmosphericState.from_numpy(z0=a.z0, z1=a.z1, pl=a.pl, p=a.p,
                                       T=a.T, vmr=a.vmr, mol_ids=a.mol_ids,
                                       device=device, dtype=f32)
    t0 = time.perf_counter()
    phases = {"inputs": t0 - t_in}
    od_fn = make_od_fn(store, iso, X, base, wing_abs=cfg["wing_abs"],
                       wing_hw=cfg["wing_hw"], continuum=cfg["continuum"],
                       line_mixing=None if y is None else {"y_air": y})
    tud_fn = make_tud_fn(a.z0, cfg["altitudes_km"],
                         n_angles=cfg["n_angles"], device=device)
    op = reduce_operator(X, cfg["dv_out"], device=device)
    plan_build_s = time.perf_counter() - t0
    grid = torch.as_tensor(X, dtype=f32, device=device)
    st = State(cfg=cfg, traffic=traffic, seed=seed, device=device,
               od_fn=od_fn, tud_fn=tud_fn, op=op, grid=grid, base=base,
               draws=ensemble_draws(N_DRAWS, seed), X=X, cols=cols, y_air=y,
               n_out=int(op.n_out), plan_build_s=plan_build_s,
               members_per_request=int(traffic["members_per_request"]),
               fault=fault, phases=phases)
    phases["plans"] = plan_build_s
    t0 = time.perf_counter()
    for i in range(int(traffic.get("warmup_requests", 2))):
        request(st, -1 - i)
    phases["warm_up"] = time.perf_counter() - t0
    return st


def _members(st, i):
    m = st.members_per_request
    return [(i * m + j) % N_DRAWS for j in range(m)]


def request(st, i):
    b = st.base
    with span("request"):
        parts = {"tau": [], "Lu": [], "Ld": []}
        ks = _members(st, i)
        run = ks[:len(ks) // 2] if st.fault == "half_batch" else ks
        for n, k in enumerate(run):
            with span("member"):
                T, vmr = member_tensors(b.T, b.vmr, st.draws, k)
                with span("od"):
                    od = st.od_fn(T, b.p, b.pl, vmr)
                if st.fault == "answer" and n == 0:
                    od = od * (1.0 + 1e-2)
                with span("tud"):
                    tud = st.tud_fn(st.grid, od, T)
                with span("reduce"):
                    red = tuple(st.op(a) for a in (tud.tau[:, :, 0],
                                                   tud.Lu[:, :, 0], tud.Ld))
                for key, v in zip(parts, red):
                    parts[key].append(v)
        if len(run) < len(ks):
            for key in parts:
                mean = torch.stack(parts[key]).mean(dim=0)
                parts[key] += [mean] * (len(ks) - len(run))
        with span("copy"):
            out = {k: torch.stack(v).cpu().numpy() for k, v in parts.items()}
    if i < 0:
        return Record(units=len(ks))
    k_out = int(st.traffic["check_outputs"])
    sample = []
    for j, k in enumerate(ks):
        idx = checks.outputs(rng_for(st.seed, 11, i, j), st.n_out, k_out)
        sample.append((k, idx, out["tau"][j][idx], out["Lu"][j][idx],
                       out["Ld"][j][idx]))
    return Record(units=len(ks), sample=sample)


def work(st, indices):
    """Work of the traced requests: K1 (the Voigt OD of each member from
    the reference's line parameters) and K2, as (ops, bytes, sfu) sums of
    per-member bounds."""
    iso, lines, a, cap = lwir.reference_geometry(st.cfg, st.cols, st.y_air)
    mix = (st.y_air != 0.0) if st.y_air is not None else np.zeros(
        lines.nu0.size, bool)
    x0, n = float(st.X[0]), st.X.size
    dx = float((st.X[-1] - st.X[0]) / (n - 1))
    k1_s, k2_s, k1_by, k2_by = 0.0, 0.0, set(), set()
    for i in indices:
        for k in _members(st, i):
            m = member(a, st.draws, k)
            prm = lwir.params(st.cfg, lines, iso, m, st.y_air, cap)
            t, by = yardstick.bound(
                *yardstick.voigt_od_work(prm, x0, dx, n, mix))
            k1_s += t
            k1_by.add(by)
            ops, nbytes, sfu = yardstick.k2_work(n, m.T.size,
                                            len(st.cfg["altitudes_km"]), 1,
                                            st.cfg["n_angles"])
            t, by = yardstick.bound(ops, nbytes, sfu)
            k2_s += t
            k2_by.add(by)
    return {"k1_bound_s": k1_s, "k1_bound_by": sorted(k1_by),
            "k2_bound_s": k2_s, "k2_bound_by": sorted(k2_by)}


def release(st, samples):
    return {"cfg": st.cfg, "cols": st.cols, "y": st.y_air, "X": st.X,
            "draws": st.draws, "limits": st.traffic["limits"],
            "n_out": st.n_out, "device": st.device}


def check(ref, samples, control_dtype=None):
    """The reference at every checked member's sampled outputs (float64;
    with ``control_dtype`` the reference in that precision stands in for
    the program's products)."""
    cfg, X, dev = ref["cfg"], ref["X"], ref["device"]
    iso, lines, a, cap = lwir.reference_geometry(cfg, ref["cols"], ref["y"])
    red = Reduction(X, cfg["dv_out"])
    if red.n_out != ref["n_out"]:
        return [("n_out_mismatch", float("inf"), 0.0)]
    mixing = ref["y"] is not None

    def reference(k, idx, dtype):
        m = member(a, ref["draws"], k)
        prm = lwir.params(cfg, lines, iso, m, ref["y"], cap)

        def od_at(pts, lo):
            od = lbl.line_sum(pts, prm, dtype=dtype, device=dev)
            if mixing:
                od = torch.clamp(od, min=0.0)
            cont = mt_ckd_od(pts, m.T, m.p, m.pl, m.vmr, m.mol_ids)
            return od + torch.as_tensor(cont, dtype=dtype, device=dev)

        return checks.member_reference(red, idx, X, od_at, m.T, a.z0,
                                       cfg["altitudes_km"], cfg["n_angles"],
                                       dtype, dev)

    prog, refs = [], []
    for i in sorted(samples):
        for k, idx, tau, Lu, Ld in samples[i]:
            refs.append(reference(k, idx, torch.float64))
            prog.append((tau, Lu, Ld) if control_dtype is None
                        else reference(k, idx, control_dtype))
    if not refs:
        return []
    return checks.with_limits(checks.compare(prog, refs), ref["limits"])
