"""Driver: cross-section lattices, the table generator
(``cli/main.py::run_xsect``; ``misc/RT_gen_AbsXS_files.py``).

A request is one molecule's (T, p) lattice, the molecules taken in turn:
``make_xsect_fn(...)(T, p)`` (SD-Voigt line parameters, the coarse far
field, its corrections and the core passes of K1, the upsample and the
merge), its rows copied into a pinned host buffer. Spans: ``request``,
``xsect``, ``copy``.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from benchkit import work as yardstick
from benchkit.harness import Record, rng_for
from benchkit.inputs.grid import axis
from benchkit.inputs.synthetic import synthetic_columns
from benchkit.reference import lbl
from benchkit.tracing import span


@dataclasses.dataclass
class State:
    cfg: dict
    traffic: dict
    seed: int
    device: torch.device
    fns: dict
    T: torch.Tensor
    p: torch.Tensor
    TT: np.ndarray
    PP: np.ndarray
    X: np.ndarray
    cols: dict
    host: torch.Tensor
    plan_build_s: float
    fault: str | None = None
    members_per_request: int = 1
    phases: dict = dataclasses.field(default_factory=dict)


def states(cfg):
    """The lattice's (T [K], p [atm]) states, T major."""
    T = np.arange(cfg["T_min"], cfg["T_max"] + 1e-9, cfg["T_step"])
    p = np.arange(cfg["p_min_atm"], cfg["p_max_atm"] + 1e-9,
                  cfg["p_step_atm"])
    TT, PP = np.meshgrid(T, p, indexing="ij")
    return TT.ravel(), PP.ravel()


def molecule_columns(cfg, seed, mol):
    """One molecule's synthetic lines (the rule of the generator's CLI:
    ``n_lines_per_molecule`` lines over the band widened by the wing),
    sorted by centre."""
    band = cfg["band"]
    m = band["line_margin"]
    cols = synthetic_columns(cfg["lines"]["n_lines_per_molecule"],
                             band["numin"] - m, band["numax"] + m,
                             species=((int(mol), 1),),
                             seed=np.random.SeedSequence(
                                 [int(seed), 3, int(mol)]).generate_state(
                                     1)[0])
    order = np.argsort(cols["nu0"], kind="stable")
    return {k: np.asarray(v)[order] for k, v in cols.items()}


def setup(cell, seed, device, control=None, fault=None):
    from radtxfr_tpu_torch.lines.store import IsoTables, from_arrays
    from radtxfr_tpu_torch.products.od import make_xsect_fn

    cfg, traffic = cell.config, cell.traffic
    t_in = time.perf_counter()
    band = cfg["band"]
    X = axis(band["numin"], band["numax"], band["dv"])
    TT, PP = states(cfg)
    f32 = torch.float32
    iso = IsoTables.load(dtype=f32, device=device)
    fns, cols, build = {}, {}, 0.0
    for mol in cfg["lines"]["molecules"]:
        c = cols[mol] = molecule_columns(cfg, seed, mol)
        store = from_arrays(c["nu0"], c["sw"], c["elower"], c["gamma_air"],
                            c["gamma_self"], c["n_air"], c["delta_air"],
                            c["mol_id"], c["local_iso_id"],
                            sd_air=c["sd_air"], dtype=f32, device=device)
        t0 = time.perf_counter()
        fns[mol] = make_xsect_fn(store, iso, X, TT, PP,
                                 profile=cfg["profile"],
                                 wing_abs=cfg["wing_abs"],
                                 wing_hw=cfg["wing_hw"])
        build += time.perf_counter() - t0
    pin = device.type == "cuda"
    host = torch.empty((TT.size, X.size), dtype=f32, pin_memory=pin)
    st = State(cfg=cfg, traffic=traffic, seed=seed, device=device, fns=fns,
               T=torch.as_tensor(TT, dtype=f32, device=device),
               p=torch.as_tensor(PP, dtype=f32, device=device), TT=TT, PP=PP,
               X=X, cols=cols, host=host, plan_build_s=build, fault=fault)
    st.phases = {"inputs": time.perf_counter() - t_in - build,
                 "plans": build}
    t0 = time.perf_counter()
    for i in range(len(fns)):
        request(st, -1 - i)
    st.phases["warm_up"] = time.perf_counter() - t0
    return st


def _molecule(st, i):
    mols = st.cfg["lines"]["molecules"]
    return mols[i % len(mols)]


def sample_points(st, i, mol):
    """The checked (states, points) of request ``i``: one state from each
    of ``check_states`` equal blocks of the lattice, and points half drawn
    over the axis, half about drawn lines' centres (the core and
    correction zones)."""
    rng = rng_for(st.seed, 13, i)
    k = int(st.traffic["check_states"])
    blocks = np.array_split(np.arange(st.TT.size), k)
    s_idx = np.array([rng.choice(b) for b in blocks])
    n_pts = int(st.traffic["check_points"])
    n = st.X.size
    x0, dx = float(st.X[0]), float((st.X[-1] - st.X[0]) / (n - 1))
    far = rng.choice(n, size=n_pts // 2, replace=False)
    nu0 = st.cols[mol]["nu0"]
    c = rng.choice(nu0[(nu0 > st.X[0]) & (nu0 < st.X[-1])],
                   size=n_pts - n_pts // 2)
    near = np.round((c + rng.normal(0.0, 0.2, c.size) - x0) / dx)
    pts = np.unique(np.clip(np.concatenate([far, near]), 0, n - 1)
                    .astype(np.int64))
    return s_idx, pts


def request(st, i):
    mol = _molecule(st, i)
    with span("request"):
        with span("xsect"):
            K = st.fns[mol](st.T, st.p)
        if st.fault == "half_batch":
            half = K.shape[0] // 2
            K = torch.cat([K[:half], K[:half].mean(dim=0, keepdim=True)
                           .expand(K.shape[0] - half, -1)])
        if st.fault == "answer":
            K = K * (1.0 + 1e-2)
        with span("copy"):
            st.host.copy_(K, non_blocking=True)
            if st.device.type == "cuda":
                torch.cuda.current_stream(st.device).synchronize()
    n_states = K.shape[0]
    if i < 0:
        return Record(units=n_states)
    s_idx, pts = sample_points(st, i, mol)
    vals = st.host.numpy()[s_idx[:, None], pts[None, :]]
    return Record(units=n_states, sample=(mol, s_idx, pts, vals), group=mol)


def _params(cfg, lines, iso, TT, PP):
    return lbl.line_params(lines, iso, TT, PP, x_self=0.0, column=1.0,
                           wing_abs=cfg["wing_abs"], wing_hw=cfg["wing_hw"])


def work(st, indices):
    """K1's work of the traced lattices (:func:`~benchkit.work.
    sd_lattice_work`) from the reference's line parameters."""
    iso = lbl.IsoData.load()
    n = st.X.size
    x0, dx = float(st.X[0]), float((st.X[-1] - st.X[0]) / (n - 1))
    per = {}
    for mol in st.cfg["lines"]["molecules"]:
        lines = lbl.Lines.from_columns(st.cols[mol], iso)
        per[mol] = yardstick.bound(*yardstick.sd_lattice_work(
            _params(st.cfg, lines, iso, st.TT, st.PP), x0, dx, n))
    t = sum(per[_molecule(st, i)][0] for i in indices)
    return {"k1_bound_s": t,
            "k1_bound_by": sorted({per[_molecule(st, i)][1]
                                   for i in indices})}


def release(st, samples):
    return {"cfg": st.cfg, "cols": st.cols, "X": st.X, "TT": st.TT,
            "PP": st.PP, "limits": st.traffic["limits"],
            "device": st.device}


def check(ref, samples, control_dtype=None):
    """The SD-Voigt reference at each checked request's sampled states and
    points; the largest |xs - xs_ref| over the largest |xs_ref| of each
    checked state (a share of the state's sampled peak)."""
    cfg, X, dev = ref["cfg"], ref["X"], ref["device"]
    iso = lbl.IsoData.load()
    n = X.size
    x0, dx = float(X[0]), float((X[-1] - X[0]) / (n - 1))
    worst = 0.0
    for i in sorted(samples):
        mol, s_idx, pts, vals = samples[i]
        lines = lbl.Lines.from_columns(ref["cols"][mol], iso)
        prm = _params(cfg, lines, iso, ref["TT"][s_idx], ref["PP"][s_idx])
        g = x0 + dx * pts
        r = lbl.line_sum(g, prm, profile="sdvoigt", dtype=torch.float64,
                         device=dev).cpu().numpy()
        if control_dtype is not None:
            vals = lbl.line_sum(g, prm, profile="sdvoigt",
                                dtype=control_dtype,
                                device=dev).double().cpu().numpy()
        if not np.isfinite(vals).all():
            return [("xs_of_peak", float("inf"),
                     float(ref["limits"]["xs_of_peak"]))]
        err = np.abs(vals - r).max(axis=1) / np.abs(r).max(axis=1)
        worst = max(worst, float(err.max()))
    if not samples:
        return []
    return [("xs_of_peak", worst, float(ref["limits"]["xs_of_peak"]))]
