"""This checkout's port against another checkout's, on one card.

    python3 kernel_ab.py --parent DIR [--out PATH] [--reps 5] [--rounds 1]

Run from the repository root. ``DIR`` is another checkout (an unpacked
``git archive`` of an earlier commit). The measurements run in four
processes, in turns: the other checkout's, this one's, this one's, the
other's (``--rounds`` times). Each process runs from its own checkout, imports that checkout's
``radtxfr_tpu_torch`` and ``chip_smoke.py`` (for the configurations),
builds that checkout's kernels there, and measures on inputs made from the
same seeds:

* the production member at full width, stage by stage as ``chip_smoke.py``
  phase 6 times it (line parameters, each K1 mode, the continuum, the OD,
  K2, the reduction, the member), and the plan build;
* every K1 pass of the differentiable OD builder (``full``), of the
  full-width XS lattice, of the HT lattice, and of the 1000-1010 cm^-1 XS
  builders (``lorentz``, ``doppler``, the correction passes and their
  ``*full`` variants), milliseconds summed per mode, with a SHA-256 of
  each output;
* K2 at the production shape in each mode the checkout has;
* d OD / d T[3] of the HT Jacobian (phase 9c's), over twice the calls.

For the member and d OD / d T[3] it also gives the milliseconds the card
spends in kernels during one call ("on the card": torch.profiler's CUDA
kernel times, summed); the rest of a call's time the card waits on the
host.

Each time is the median of ``--reps`` calls, each timed on its own with
CUDA events after a warm-up call.

It prints each number as other -> this (each the mean of its
processes), whether each K1 pass gave bit-identical outputs in all four
processes, and, given ``--out``, writes everything there as JSON with the
card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import inspect
import json
import os
import subprocess
import sys
import tempfile
import time


def events_ms(fn, reps):
    """Median CUDA-event milliseconds of ``fn()`` over ``reps`` calls, each
    timed on its own, after one warm-up; returns (ms, last result)."""
    import torch
    out = fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        a.record()
        out = fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2], out


def device_ms(fn):
    """Milliseconds the card spends in kernels during one call of ``fn()``
    (the sum of torch.profiler's CUDA kernel times), or None where the
    profiler records none."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    total = sum(e.self_device_time_total for e in prof.key_averages())
    return total / 1e3 or None


def digest(t):
    return hashlib.sha256(t.detach().contiguous().cpu().numpy().tobytes()
                          ).hexdigest()


def child(out_path, reps):
    """Measure the checkout in the working directory; write the JSON."""
    sys.path[0] = os.getcwd()
    import numpy as np
    import torch

    import chip_smoke as cs
    from radtxfr_tpu_torch import _build
    from radtxfr_tpu_torch.atmos.profile import std_atmosphere
    from radtxfr_tpu_torch.core.constants import C1, C2
    from radtxfr_tpu_torch.core.grid import arange_drift_free
    from radtxfr_tpu_torch.kernels import fused_tud
    from radtxfr_tpu_torch.kernels.linemixing_data import y_air_for_store
    from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist
    from radtxfr_tpu_torch.lines.store import IsoTables
    from radtxfr_tpu_torch.lines.synthetic import synthetic_lines
    from radtxfr_tpu_torch.products.od import (make_ht_fn, make_od_fn,
                                               make_od_ht_fn, make_xsect_fn)
    from radtxfr_tpu_torch.products.tud import (_layers_below,
                                                downwelling_quadrature,
                                                make_tud_fn)
    from radtxfr_tpu_torch.sensor.resolution import reduce_operator

    _build.library()
    dev = torch.device("cuda", 0)
    f32 = torch.float32
    cs.warm_up(dev)
    res = {"ms": {}, "k1": {}}
    ms = res["ms"]

    def k1(case, fn, prm, calls, Y=None):
        for call in calls:
            mode = call[2]
            if mode == "ht":
                continue
            t, out = events_ms(lambda c=call: fn.run_call(c, prm, Y), reps)
            r = res["k1"].setdefault(f"{case} {mode}",
                                     {"ms": 0.0, "passes": 0, "sha": []})
            r["ms"] += t
            r["passes"] += 1
            r["sha"].append(digest(out))

    # d OD / d T[3] of the HT Jacobian (phase 9c), first: host-bound, so
    # measured before the rest of the process's allocations
    jac_store, extras = cs.ht_jac_case(dev)
    b64 = std_atmosphere(device=dev)
    fn = make_od_ht_fn(jac_store, IsoTables.load(device=dev),
                       arange_drift_free(*cs.HT_JAC_BAND), b64,
                       extras=extras, differentiable=True)
    e3 = torch.zeros_like(b64.T)
    e3[cs.HT_JAC_LAYER] = 1.0

    def jvp3():
        return torch.func.jvp(lambda T_: fn(T_, b64.p, b64.pl, b64.vmr),
                              (b64.T,), (e3,))[1]

    ms["ht jacobian dOD/dT[3]"], _ = events_ms(jvp3, 2 * reps)
    ms["ht jacobian dOD/dT[3] on the card"] = device_ms(jvp3)
    del fn, jac_store

    # the production member (phase 6)
    iso = IsoTables.load(device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    store = derived_lwir_linelist(cs.FULL_BAND[0] - cs.MARGIN,
                                  cs.FULL_BAND[1] + cs.MARGIN, device=dev,
                                  dtype=f32)
    X = arange_drift_free(*cs.FULL_BAND)
    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr
    y = y_air_for_store(store.host_view())
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    od_fn = make_od_fn(store, iso, X, base, continuum="mt_ckd",
                       line_mixing={"y_air": y})
    torch.cuda.synchronize()
    ms["plan build"] = (time.perf_counter() - t0) * 1e3
    ms["line_params"], (prm, Y) = events_ms(
        lambda: od_fn.line_params(T, p, pl, vmr), reps)
    k1("production", od_fn, prm, od_fn.calls, Y)
    ms["continuum"], _ = events_ms(lambda: od_fn.cont(T, p, pl, vmr), reps)
    ms["od total"], od = events_ms(lambda: od_fn(T, p, pl, vmr), reps)
    tud_fn = make_tud_fn(base.z0.cpu().numpy(), cs.ALTITUDES, device=dev)
    x = torch.as_tensor(X, dtype=f32, device=dev)
    ms["K2 tud"], tud = events_ms(lambda: tud_fn(x, od, T), reps)
    op = reduce_operator(X, 0.25, device=dev)
    ms["reduce"], _ = events_ms(lambda: (op(tud.tau[:, :, 0]),
                                         op(tud.Lu[:, :, 0]), op(tud.Ld)),
                                reps)

    def member():
        t = tud_fn(x, od_fn(T, p, pl, vmr), T)
        return op(t.tau[:, :, 0]), op(t.Lu[:, :, 0]), op(t.Ld)

    ms["member"], _ = events_ms(member, reps)
    ms["member on the card"] = device_ms(member)
    del od_fn, od, tud, prm, Y

    # the differentiable OD builder's full passes (the Jacobian path)
    jac = make_od_fn(store, iso, X, base, continuum="mt_ckd",
                     differentiable=True)
    k1("jacobian", jac, jac.line_params(T, p, pl, vmr)[0], jac.calls)
    del jac, store

    # K2 at the production shape, in each mode this checkout has
    gen = torch.Generator(device=dev).manual_seed(0)
    od = 10.0 ** (5.0 * torch.rand((base.n_layers, X.size), generator=gen,
                                   device=dev, dtype=f32) - 4.0)
    inv_t = (1.0 / T).contiguous()
    mus = torch.ones(1, dtype=f32, device=dev)
    snap = torch.as_tensor(_layers_below(base.z0.cpu().numpy(),
                                         cs.ALTITUDES),
                           dtype=torch.int32, device=dev)
    sec, w = (torch.as_tensor(a, dtype=f32, device=dev)
              for a in downwelling_quadrature(30))
    args = (od, x, inv_t, mus, snap, sec, w)
    ms["K2 planck"], _ = events_ms(lambda: fused_tud.tud_compose(*args),
                                   reps)
    if "B" in inspect.signature(fused_tud.tud_compose).parameters:
        nu = x * 100.0
        B = (((nu * nu * nu) * (C1 * 1e4))[None, :] / torch.expm1(
            (nu * C2)[None, :] * inv_t[:, None])).contiguous()
        ms["K2 B read"], _ = events_ms(
            lambda: fused_tud.tud_compose(*args, B=B), reps)
        del B
    del od, args

    # the full-width XS lattice (the CLI's)
    a = cs.xs_args(cs.XS_CLI)
    xs_store = synthetic_lines(a.synthetic, nu_min=a.numin - cs.XS_WING,
                               nu_max=a.numax + cs.XS_WING, seed=a.seed,
                               device=dev)
    xs = make_xsect_fn(xs_store, iso, arange_drift_free(a.numin, a.numax,
                                                        a.dv),
                       cs.XS_T, np.ones_like(cs.XS_T), profile="sdvoigt",
                       wing_abs=cs.XS_WING)
    Ts, ps = cs.xs_states(dev)
    k1("xs lattice", xs, xs.line_params(Ts, ps), xs.all_calls())
    del xs, xs_store

    # the 1000-1010 cm^-1 XS builders (phase 3c)
    sub = cs.xs_lines(dev)
    Xs = arange_drift_free(*cs.XS_SUB)

    def build(**kw):
        return make_xsect_fn(sub, iso, Xs, cs.XS_T, np.ones_like(cs.XS_T),
                             wing_abs=cs.XS_WING, tile=cs.XS_BENCH["tile"],
                             **kw)

    main = build(profile="sdvoigt")
    full_calls = [(c[0], c[1], c[2] + "full") for c in main.corr_calls[::3]]
    k1("xs sub-band", main, main.line_params(Ts, ps),
       main.all_calls() + full_calls)
    for prof in ("lorentz", "doppler"):
        fn = build(profile=prof)
        k1("xs sub-band", fn, fn.line_params(Ts, ps), fn.all_calls())
    del main, fn, sub

    # the HT lattice (phase 8)
    ht_store, extras = cs.ht_lattice_case(dev)
    ht = make_ht_fn(ht_store, iso, arange_drift_free(*cs.HT_BAND), cs.XS_T,
                    np.ones_like(cs.XS_T), extras=extras)
    k1("ht lattice", ht, ht.line_params(Ts, ps), ht.all_calls())
    del ht, ht_store

    with open(out_path, "w") as f:
        json.dump(res, f)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--out", help="write the results there as JSON")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--rounds", type=int, default=1,
                    help="repeat the four processes this many times")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.child:
        return child(a.child, a.reps)
    if not a.parent:
        ap.error("--parent is required")
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    here = os.path.dirname(os.path.abspath(__file__))
    trees = {"other": os.path.abspath(a.parent), "this": here}
    runs = {"other": [], "this": []}
    with tempfile.TemporaryDirectory() as tmp:
        order = ("other", "this", "this", "other") * a.rounds
        for i, who in enumerate(order):
            path = os.path.join(tmp, f"{i}.json")
            t0 = time.perf_counter()
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--child", path, "--reps", str(a.reps)],
                           cwd=trees[who], check=True)
            with open(path) as f:
                runs[who].append(json.load(f))
            print(f"[ab] {who} ({trees[who]}) measured in "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    res = {"card": card, "other": trees["other"], "runs": runs,
           "ms": {}, "k1": {}}

    def mean(vals):
        vals = [v for v in vals if v is not None]
        return sum(vals) / len(vals) if vals else None

    def fmt(vals):
        return " / ".join("-" if v is None else f"{v:.4f}" for v in vals)

    for key in runs["this"][0]["ms"]:
        per = {who: [r["ms"].get(key) for r in runs[who]] for who in runs}
        res["ms"][key] = {who: mean(v) for who, v in per.items()}
        print(f"[ab] {key}: {fmt([res['ms'][key]['other']])} -> "
              f"{fmt([res['ms'][key]['this']])} ms (each process: "
              f"{fmt(per['other'])} -> {fmt(per['this'])}) [{card}]",
              flush=True)
    for key in runs["this"][0]["k1"]:
        shas = [r["k1"].get(key, {}).get("sha") for r in
                runs["other"] + runs["this"]]
        same = all(s == shas[0] for s in shas)
        o = mean(r["k1"].get(key, {}).get("ms") for r in runs["other"])
        t = mean(r["k1"][key]["ms"] for r in runs["this"])
        res["k1"][key] = {"other": o, "this": t, "identical": same,
                          "passes": runs["this"][0]["k1"][key]["passes"]}
        print(f"[ab] K1 {key} ({res['k1'][key]['passes']} passes): "
              f"{fmt([o])} -> {fmt([t])} ms, bit-identical {same} "
              f"[{card}]", flush=True)
    if a.out:
        os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
        with open(a.out, "w") as f:
            json.dump(res, f, indent=1)


if __name__ == "__main__":
    main()
