"""Driver: the TUD Jacobian, the retrieval users' path (``cli/main.py::
_mesh_jacobian`` on a one-card (1 x 1) mesh).

A request is one perturbed member (the ensemble's draw rule from the seed)
and ``directions_per_request`` one-hot directions: request ``i`` takes
directions ``(i d + j) mod 198`` of the frozen direction rule (T, H2O, O3,
layer by layer). ``make_tud_jacobian_fn``'s run computes the primal and
the directions' tangents (K1 ``full`` for the OD, K3 for its tangents, the
continuum's and the composition's tangents in plain torch under
``torch.func.jvp`` and ``vmap``); the primal's and each direction's tau,
Lu and Ld are reduced by the banded operator and copied to the host. Line
mixing is off: the differentiable kernels carry no mixing tangent, and the
program's Jacobian runs without it. Spans: ``request``, ``jacobian``,
``reduce``, ``copy``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchkit import checks, lwir
from benchkit.harness import Record, rng_for
from benchkit.inputs.atmosphere import (N_DRAWS, Atmosphere, ensemble_draws,
                                        jacobian_directions, member,
                                        member_tensors)
from benchkit.reference import lbl
from benchkit.reference.continuum import mt_ckd_od
from benchkit.reference.radiative import Reduction, compose
from benchkit.tracing import span

#: central-difference steps of the reference's OD tangent: T [K], and a
#: share of the layer's vmr
STEP_T = 1e-3
STEP_VMR = 1e-4


@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    run: object
    op: object
    base: object
    draws: tuple
    V_T: np.ndarray
    V_vmr: np.ndarray
    X: np.ndarray
    cols: dict
    n_out: int
    plan_build_s: float
    directions_per_request: int
    fault: str | None = None
    phases: dict = dataclasses.field(default_factory=dict)

    def directions(self, i: int) -> list:
        """Request ``i``'s directions: the next ``directions_per_request``
        of the frozen rule's, cyclically."""
        d = self.directions_per_request
        return [(i * d + j) % self.V_T.shape[0] for j in range(d)]

    @staticmethod
    def member_of(i: int) -> int:
        """Request ``i``'s member of the seed's draws."""
        return i % N_DRAWS


def setup(cell, seed, device, control=None, fault=None):
    from radtxfr_tpu_torch.atmos.profile import AtmosphericState
    from radtxfr_tpu_torch.dist.fused_ensemble import make_tud_jacobian_fn
    from radtxfr_tpu_torch.dist.mesh import make_mesh
    from radtxfr_tpu_torch.lines.store import IsoTables, from_arrays
    from radtxfr_tpu_torch.sensor.resolution import reduce_operator

    cfg, traffic = cell.config, cell.traffic
    t_in = time.perf_counter()
    cols, X, _ = lwir.inputs(cfg, line_mixing=False)
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
    V_T, V_vmr, _ = jacobian_directions(a)
    t0 = time.perf_counter()
    phases = {"inputs": t0 - t_in}
    mesh = make_mesh(1, 1, devices=[device])
    _, run = make_tud_jacobian_fn(store, iso, X, base, cfg["altitudes_km"],
                                  mesh, n_angles=cfg["n_angles"],
                                  continuum=cfg["continuum"],
                                  wing_abs=cfg["wing_abs"],
                                  wing_hw=cfg["wing_hw"])
    op = reduce_operator(X, cfg["dv_out"], device=device)
    plan_build_s = time.perf_counter() - t0
    st = State(cfg=cfg, traffic=traffic, seed=seed, device=device, run=run,
               op=op, base=base, draws=ensemble_draws(N_DRAWS, seed),
               V_T=V_T, V_vmr=V_vmr, X=X, cols=cols, n_out=int(op.n_out),
               plan_build_s=plan_build_s,
               directions_per_request=int(traffic["directions_per_request"]),
               fault=fault, phases=phases)
    phases["plans"] = plan_build_s
    t0 = time.perf_counter()
    for i in range(int(traffic.get("warmup_requests", 1))):
        request(st, -1 - i)
    phases["warm_up"] = time.perf_counter() - t0
    return st


def request(st, i):
    b, n = st.base, st.X.size
    dirs = st.directions(i)
    with span("request"):
        T, vmr = member_tensors(b.T, b.vmr, st.draws, st.member_of(i))
        run = dirs[:len(dirs) // 2] if st.fault == "half_batch" else dirs
        with span("jacobian"):
            prim, tan = st.run(T, vmr, st.V_T[run], st.V_vmr[run])
        if st.fault == "answer":
            tan = {k: torch.cat([v[:1] * (1.0 + 1e-2), v[1:]])
                   for k, v in tan.items()}
        if len(run) < len(dirs):
            tan = {k: torch.cat([v, v.mean(dim=0, keepdim=True).expand(
                len(dirs) - len(run), *v.shape[1:])]) for k, v in tan.items()}
        with span("reduce"):
            red_p = [st.op(prim["tau"][:n, :, 0]), st.op(prim["Lu"][:n, :, 0]),
                     st.op(prim["Ld"][:n])]
            red_t = [torch.stack([st.op(tan["tau"][d, :n, :, 0])
                                  for d in range(len(dirs))]),
                     torch.stack([st.op(tan["Lu"][d, :n, :, 0])
                                  for d in range(len(dirs))]),
                     torch.stack([st.op(tan["Ld"][d, :n])
                                  for d in range(len(dirs))])]
        with span("copy"):
            out_p = [a.cpu().numpy() for a in red_p]
            out_t = [a.cpu().numpy() for a in red_t]
    if i < 0:
        return Record(units=len(dirs))
    idx = checks.outputs(rng_for(st.seed, 17, i), st.n_out,
                         int(st.traffic["check_outputs"]))
    sample = (st.member_of(i), dirs, idx, tuple(a[idx] for a in out_p),
              tuple(a[:, idx] for a in out_t))
    return Record(units=len(dirs), sample=sample)


def work(st, indices):
    """The od_tangent roofline's work is its metric file's own."""
    return {}


def release(st, samples):
    return {"cfg": st.cfg, "cols": st.cols, "X": st.X, "draws": st.draws,
            "limits": st.traffic["limits"], "n_out": st.n_out,
            "device": st.device}


def _layer(a: Atmosphere, l: int) -> Atmosphere:
    return dataclasses.replace(a, z0=a.z0[l:l + 1], z1=a.z1[l:l + 1],
                               pl=a.pl[l:l + 1], p=a.p[l:l + 1],
                               T=a.T[l:l + 1], vmr=a.vmr[l:l + 1])


def _layer_states(cfg, lines, iso, m, cap, prm, direction):
    """The two states of one one-hot direction (variable, layer ``l``) a
    central difference takes, as (step, [(layer-l params, layer-l state)]
    at +step and -step): each line's window held at the member's (the
    program's tangent does not move it)."""
    key, l = direction
    if key == "T":
        h = STEP_T

        def at(s):
            return dataclasses.replace(m, T=np.where(
                np.arange(m.T.size) == l, m.T + s, m.T))
    else:
        c = list(m.mol_ids).index(int(key))
        h = STEP_VMR * max(float(m.vmr[l, c]), 1e-12)

        def at(s):
            v = m.vmr.copy()
            v[l, c] += s
            return dataclasses.replace(m, vmr=v)
    out = []
    for s in (h, -h):
        one = _layer(at(s), l)
        p = lwir.params(cfg, lines, iso, one, None, cap[l:l + 1])
        out.append((dataclasses.replace(p, wing=prm.wing[l:l + 1]), one))
    return h, out


def _od_at(pts, prm, a, dtype, dev):
    """(nL, P) OD of state ``a`` at ``pts``: the lines (``prm``) and the
    continuum."""
    od = lbl.line_sum(pts, prm, dtype=dtype, device=dev)
    cont = mt_ckd_od(pts, a.T, a.p, a.pl, a.vmr, a.mol_ids)
    return od + torch.as_tensor(cont, dtype=dtype, device=dev)


def _reference(cfg, X, red, lines, iso, a, cap, draws, k, dirs, idx, labels,
               dtype, dev):
    """Reference reduced primal ((k,nZ), (k,nZ), (k,)) and tangents
    ((nd,k,nZ), (nd,k,nZ), (nd,k)) of member ``k`` at outputs ``idx``: the
    member's OD at every fine point each output reads (the lines in
    ``dtype``), each direction's OD tangent by central differences of its
    layer (float64), then the composition and its tangent
    (``torch.func.jvp`` of the layer recursion, pointwise in wavenumber, so
    over every output's points at once) in ``dtype``, and the reduction."""
    m = member(a, draws, k)
    prm = lwir.params(cfg, lines, iso, m, None, cap)
    T = torch.as_tensor(m.T, dtype=dtype, device=dev)
    f64 = torch.float64
    sup = [red.support(int(i)) for i in idx]
    ods, dods = [], [[] for _ in dirs]
    steps = [_layer_states(cfg, lines, iso, m, cap, prm, labels[d])
             for d in dirs]
    for lo, hi in sup:
        pts = X[lo:hi]
        ods.append(_od_at(pts, prm, m, dtype, dev))
        for j, d in enumerate(dirs):
            h, ((p_hi, s_hi), (p_lo, s_lo)) = steps[j]
            dods[j].append((_od_at(pts, p_hi, s_hi, f64, dev)[0]
                            - _od_at(pts, p_lo, s_lo, f64, dev)[0])
                           / (2.0 * h))
    od = torch.cat(ods, dim=1)
    nu = torch.as_tensor(np.concatenate([X[lo:hi] for lo, hi in sup]),
                         dtype=f64, device=dev)

    def comp(o, t):
        return compose(o, nu, t, a.z0, cfg["altitudes_km"], cfg["n_angles"])

    def reduced(ys):
        """Each output's reduced value of (..., all points) ``ys``."""
        out, at = [[] for _ in ys], 0
        for i, (lo, hi) in zip(idx, sup):
            for acc, y in zip(out, ys):
                acc.append(red.apply(int(i), y[..., at:at + hi - lo], lo))
            at += hi - lo
        return [torch.stack(v).double().cpu().numpy() for v in out]

    prim = reduced(comp(od, T))
    tans = []
    for j, d in enumerate(dirs):
        key, l = labels[d]
        dod = torch.zeros_like(od, dtype=f64)
        dod[l] = torch.cat(dods[j])
        dT = torch.zeros(m.T.size, dtype=f64, device=dev)
        dT[l] = 1.0 if key == "T" else 0.0
        _, t = torch.func.jvp(comp, (od, T), (dod.to(dtype), dT.to(dtype)))
        tans.append(reduced(t))
    return (tuple(prim),
            tuple(np.stack([t[q] for t in tans]) for q in range(3)))


def compare_tangents(prog: list, ref: list) -> list:
    """[(name, value)]: for each product, the largest over the checked
    directions of max |J - J_ref| over the larger of the direction's own
    peak |J_ref| and the median direction's (some directions all but
    vanish at some outputs); prog and ref lists of (dtau, dLu, dLd), each
    (nd, ...)."""
    vals = []
    for name, k in (("dtau_of_peak", 0), ("dlu_of_peak", 1),
                    ("dld_of_peak", 2)):
        gaps, peaks = [], []
        for p, r in zip(prog, ref):
            for d in range(r[k].shape[0]):
                gaps.append(float(np.abs(p[k][d] - r[k][d]).max()))
                peaks.append(float(np.abs(r[k][d]).max()))
        bad = not all(np.isfinite(p[k]).all() for p in prog)
        scale = np.maximum(np.asarray(peaks), np.median(peaks))
        v = float(np.max(np.asarray(gaps) / scale)) if gaps else 0.0
        vals.append((name, float("inf") if bad else v))
    return vals


def check(ref, samples, control_dtype=None):
    """The reference at every checked request's sampled outputs: the
    primal as the TUD cell compares it, and every direction's reduced
    tangent (with ``control_dtype`` the reference's composition and its
    tangent in that precision, the OD's tangent rounded to it, stand in
    for the program's products)."""
    cfg, X, dev = ref["cfg"], ref["X"], ref["device"]
    iso, lines, a, cap = lwir.reference_geometry(
        cfg, ref["cols"], None, ratio=lwir.DIFFERENTIABLE_RATIO)
    red = Reduction(X, cfg["dv_out"])
    if red.n_out != ref["n_out"]:
        return [("n_out_mismatch", float("inf"), 0.0)]
    _, _, labels = jacobian_directions(a)
    prog_p, ref_p, prog_t, ref_t = [], [], [], []
    for i in sorted(samples):
        k, dirs, idx, prim, tan = samples[i]
        rp, rt = _reference(cfg, X, red, lines, iso, a, cap, ref["draws"], k,
                            dirs, idx, labels, torch.float64, dev)
        if control_dtype is not None:
            prim, tan = _reference(cfg, X, red, lines, iso, a, cap,
                                   ref["draws"], k, dirs, idx, labels,
                                   control_dtype, dev)
        ref_p.append(rp)
        ref_t.append(rt)
        prog_p.append(prim)
        prog_t.append(tan)
    if not ref_p:
        return []
    return checks.with_limits(checks.compare(prog_p, ref_p)
                              + compare_tangents(prog_t, ref_t),
                              ref["limits"])
