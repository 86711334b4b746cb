#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``radtxfr_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing its result on its own line:

1. Device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives.
2. Build: compile the CUDA kernels of ``radtxfr_tpu_torch/csrc`` (nvcc).
3. K1 (``csrc/fused_xsect.cu``) against its plain PyTorch version on every
   pass of the production OD builder over a 700-740 cm^-1 sub-band at
   5e-4 cm^-1 (derived line list, 66 layers, line mixing): error <= 2e-6
   of the peak of the line OD of the pass's layers (the float32 bound of
   the JAX package's Pallas OD, README.md "≤2e-6 of peak"), and within
   ``K1_OWN_BOUND`` of the pass's own output peak, so a pass that writes
   zeros or a wrong shape fails whatever the other passes add.
4. K2 (``csrc/fused_tud.cu``) against its plain version at the production
   width (1,440,001 points, 66 layers, 9 altitudes, 30 angles): tau, Lu and
   Ld within 5e-6 of peak.
5. The main path: ``run_tud`` on the production configuration
   (``tud --derived --line-mixing --continuum mt_ckd --numin 690 --numax
   1410 --dv 0.0005``, 4 members, batch 2) with every kernel's launch count
   reset before and read after; finite products, 0 <= tau <= 1, La and
   Ld > 0 (tau down to -1e-6: the reduction's cubic resample rings by
   rounding amounts around zero); then a second, warm run for its times.
   Then the same path on a 5 cm^-1 band on the card and on the CPU (plain
   versions), whose reduced products must agree within 1e-5 of peak.
6. Where one member's time goes (CUDA events per stage).

It ends with one JSON line of kernel results and, last, the device line.
Any failed check raises; the script then exits non-zero without the last
line. There is no CPU fallback.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from radtxfr_tpu_torch import _build  # noqa: E402
from radtxfr_tpu_torch.atmos.profile import std_atmosphere  # noqa: E402
from radtxfr_tpu_torch.cli.main import build_parser, run_tud  # noqa: E402
from radtxfr_tpu_torch.core.grid import arange_drift_free  # noqa: E402
from radtxfr_tpu_torch.kernels import fused_tud, fused_xsect  # noqa: E402
from radtxfr_tpu_torch.kernels.linemixing_data import (  # noqa: E402
    y_air_for_store)
from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist  # noqa: E402
from radtxfr_tpu_torch.lines.store import IsoTables  # noqa: E402
from radtxfr_tpu_torch.products.od import make_od_fn  # noqa: E402
from radtxfr_tpu_torch.products.tud import (_layers_below,  # noqa: E402
                                            downwelling_quadrature)

ALTITUDES = [0.061, 0.305, 1.524, 3.048, 6.096, 9.144, 12.192, 15.24, 500.0]
PRODUCTION = ("tud --derived --line-mixing --continuum mt_ckd --numin 690 "
              "--numax 1410 --dv 0.0005 --n-atmos 4 --batch 2")
K1_BOUND = 2e-6
# and of the pass's own output peak: the core pass is a difference of two
# near-equal float32 line shapes (Weideman - asym) in the high-pressure
# layers, so rounding there is ~1e-2 of its own small peak (PERF.md)
K1_OWN_BOUND = {"asym": 2e-6, "core": 5e-2, "mix": 2e-6}
K2_BOUND = 5e-6
SLICE_BOUND = 1e-5


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def cuda_ms(fn, reps):
    """Mean milliseconds of ``fn()`` on the current stream (CUDA events),
    after one warm-up call; returns (ms, last result)."""
    out = fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps, out


def phase_device():
    check(torch.cuda.is_available(),
          "no CUDA device: torch.cuda.is_available() is false")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0].strip()
    print(card)
    name = torch.cuda.get_device_name(0)
    print(f"[1 device] torch {torch.__version__} CUDA {torch.version.cuda}; "
          f"{name}; count {torch.cuda.device_count()}", flush=True)
    return card, name


def warm_up(dev, seconds=1.0):
    """Keep the card busy for ``seconds`` so the timings that follow do not
    include its clock ramp from idle."""
    a = torch.randn((4096, 4096), device=dev)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        a = torch.tanh(a @ a)
        torch.cuda.synchronize()


def phase_build():
    t0 = time.perf_counter()
    path = _build.library()._name
    print(f"[2 build] {os.path.relpath(path)} built and loaded in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)


def phase_k1(dev, card):
    f32 = torch.float32
    store = derived_lwir_linelist(675.0, 765.0, device=dev, dtype=f32)
    iso = IsoTables.load(device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(700.0, 740.0, 0.0005)
    y = y_air_for_store(store.host_view())
    od_fn = make_od_fn(store, iso, X, base, continuum="mt_ckd",
                       line_mixing={"y_air": y})
    prm, Y = od_fn.line_params(base.T, base.p, base.pl, base.vmr)
    line_od = torch.zeros((base.n_layers, X.size), dtype=f32, device=dev)
    runs = []
    for call in od_fn.calls:
        k_ms, k_out = cuda_ms(lambda: od_fn.run_call(call, prm, Y), 5)
        again = od_fn.run_call(call, prm, Y)
        check(torch.equal(k_out, again),
              f"K1 {call[2]}: two launches on the same inputs differ")
        p_ms, p_out = cuda_ms(lambda: od_fn.run_call(
            call, prm, Y, kernel=fused_xsect.xsect_fused_plain), 1)
        line_od[call[0].long()] += p_out
        runs.append((call, k_ms, p_ms, (k_out - p_out).abs().max().item(),
                     p_out.abs().max().item()))
    stats = {}
    for (lay, dplan, mode), k_ms, p_ms, err, own in runs:
        check(own > 0.0, f"K1 {mode}: the plain pass is zero on the band")
        peak = line_od[lay.long()].abs().max().item()
        rel, rel_own = err / peak, err / own
        print(f"[3 K1 {mode}] layers {lay.numel()} tile {dplan.tile} block "
              f"{dplan.block} tiles {dplan.n_tiles}: max|kernel-plain| "
              f"{err:.3e} = {rel:.3e} of the layers' line-OD peak "
              f"{peak:.4e} = {rel_own:.3e} of the pass's own peak "
              f"{own:.4e}; kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms "
              f"[{card}]", flush=True)
        check(rel <= K1_BOUND, f"K1 {mode}: {rel:.3e} of the line-OD peak "
              f"> {K1_BOUND}")
        check(rel_own <= K1_OWN_BOUND[mode], f"K1 {mode}: {rel_own:.3e} of "
              f"the pass's own peak > {K1_OWN_BOUND[mode]}")
        s = stats.setdefault(mode, {"max_abs_err": 0.0, "ms": 0.0,
                                    "plain_ms": 0.0})
        s["max_abs_err"] = max(s["max_abs_err"], err)
        s["ms"] += k_ms
        s["plain_ms"] += p_ms
    check(set(stats) == set(fused_xsect.MODES),
          f"K1 sub-band exercised modes {sorted(stats)}")
    return stats


def phase_k2(dev, card):
    f32 = torch.float32
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(690.0, 1410.0, 0.0005)
    gen = torch.Generator(device=dev).manual_seed(0)
    # log-uniform layer OD from 1e-4 (transparent) to 10 (opaque)
    od = 10.0 ** (5.0 * torch.rand((base.n_layers, X.size), generator=gen,
                                   device=dev, dtype=f32) - 4.0)
    x = torch.as_tensor(X, dtype=f32, device=dev)
    inv_t = (1.0 / base.T).contiguous()
    mus = torch.ones(1, dtype=f32, device=dev)
    snap = torch.as_tensor(_layers_below(base.z0.cpu().numpy(), ALTITUDES),
                           dtype=torch.int32, device=dev)
    sec, w = (torch.as_tensor(a, dtype=f32, device=dev)
              for a in downwelling_quadrature(30))
    args = (od, x, inv_t, mus, snap, sec, w)
    k_ms, got = cuda_ms(lambda: fused_tud.tud_compose(*args), 5)
    again = fused_tud.tud_compose(*args)
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "K2: two launches on the same inputs differ")
    p_ms, want = cuda_ms(lambda: fused_tud.tud_compose_plain(*args), 1)
    err_max = 0.0
    for name, g, r in zip(("tau", "Lu", "Ld"), got, want):
        err = (g - r).abs().max().item()
        rel = err / r.abs().max().item()
        err_max = max(err_max, err)
        print(f"[4 K2 {name}] shape {tuple(g.shape)}: max|kernel-plain| "
              f"{err:.3e} = {rel:.3e} of peak", flush=True)
        check(rel <= K2_BOUND, f"K2 {name}: {rel:.3e} of peak > {K2_BOUND}")
    print(f"[4 K2] {X.size} points x 66 layers, 9 altitudes, 30 angles: "
          f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms [{card}]", flush=True)
    return {"max_abs_err": err_max, "ms": k_ms, "plain_ms": p_ms}


def phase_main(card):
    for m in fused_xsect.MODES:
        fused_xsect.LAUNCHES[m] = 0
    fused_tud.LAUNCHES["tud"] = 0
    args = build_parser().parse_args(PRODUCTION.split())
    timings = {}
    x_lo, out = run_tud(args, "cuda", timings)
    launches = dict(fused_xsect.LAUNCHES, tud=fused_tud.LAUNCHES["tud"])
    print(f"[5 main] launches during run_tud: {launches}", flush=True)
    for k, n in launches.items():
        check(n > 0, f"kernel {k} was not launched by the main path")
    n, n_out, n_zs = args.n_atmos, x_lo.size, len(args.altitudes)
    check(out["tau"].shape == (n, n_out, n_zs)
          and out["Lu"].shape == (n, n_out, n_zs)
          and out["Ld"].shape == (n, n_out), "product shapes")
    for k, v in out.items():
        check(np.isfinite(v).all(), f"{k} has non-finite values")
    tau = out["tau"]
    # the reduction's cubic resample may ring by rounding amounts around
    # stretches of exactly zero transmittance
    check(tau.min() >= -1e-6 and tau.max() <= 1.0,
          f"tau outside [0, 1]: [{tau.min()}, {tau.max()}]")
    check(out["Lu"].min() > 0.0 and out["Ld"].min() > 0.0,
          "La and Ld must be positive")
    per = timings["members_s"] / n
    warm = {}
    run_tud(args, "cuda", warm)
    print(f"[5 main] {n} members x 1440001 points -> {n_out} x {n_zs}: "
          f"tau in [{tau.min():.4g}, {tau.max():.4g}], La in "
          f"[{out['Lu'].min():.4g}, {out['Lu'].max():.4g}], Ld in "
          f"[{out['Ld'].min():.4g}, {out['Ld'].max():.4g}]", flush=True)
    print(f"[5 main] plan build {timings['build_s']:.3f} s; "
          f"{per:.4f} s per member; {1.0 / per:.4f} spectra/s; chunks of "
          f"{args.batch} members: {['%.4f s' % c for c in timings['chunk_s']]}"
          f"; a second run_tud: plan build {warm['build_s']:.3f} s, "
          f"{warm['members_s'] / n:.4f} s per member, chunks "
          f"{['%.4f s' % c for c in warm['chunk_s']]} [{card}]", flush=True)

    # the same path on a small band: the card against the CPU's plain run
    small = build_parser().parse_args(
        "tud --derived --line-mixing --continuum mt_ckd --numin 718 "
        "--numax 723 --dv 0.0005 --n-atmos 2 --batch 2".split())
    _, gpu = run_tud(small, "cuda")
    _, cpu = run_tud(small, "cpu")
    for k in ("tau", "Lu", "Ld"):
        rel = np.abs(gpu[k] - cpu[k]).max() / np.abs(cpu[k]).max()
        print(f"[5 slice] 718-723 cm^-1, 2 members, {k}: card vs CPU plain "
              f"{rel:.3e} of peak", flush=True)
        check(rel <= SLICE_BOUND, f"slice {k}: {rel:.3e} > {SLICE_BOUND}")
    return launches


def phase_breakdown(dev, card):
    f32 = torch.float32
    store = derived_lwir_linelist(665.0, 1435.0, device=dev, dtype=f32)
    iso = IsoTables.load(device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(690.0, 1410.0, 0.0005)
    y = y_air_for_store(store.host_view())
    t0 = time.perf_counter()
    od_fn = make_od_fn(store, iso, X, base, continuum="mt_ckd",
                       line_mixing={"y_air": y})
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr
    ms = {}
    ms["line_params"], (prm, Y) = cuda_ms(
        lambda: od_fn.line_params(T, p, pl, vmr), 3)
    for call in od_fn.calls:
        t, _ = cuda_ms(lambda: od_fn.run_call(call, prm, Y), 3)
        ms[f"K1 {call[2]}"] = ms.get(f"K1 {call[2]}", 0.0) + t
    ms["continuum"], _ = cuda_ms(lambda: od_fn.cont(T, p, pl, vmr), 3)
    ms["od total"], od = cuda_ms(lambda: od_fn(T, p, pl, vmr), 3)
    from radtxfr_tpu_torch.products.tud import make_tud_fn
    from radtxfr_tpu_torch.sensor.resolution import reduce_operator

    tud_fn = make_tud_fn(base.z0.cpu().numpy(), ALTITUDES, device=dev)
    x = torch.as_tensor(X, dtype=f32, device=dev)
    ms["K2 tud"], tud = cuda_ms(lambda: tud_fn(x, od, T), 3)
    op = reduce_operator(X, 0.25, device=dev)
    ms["reduce"], _ = cuda_ms(lambda: (op(tud.tau[:, :, 0]),
                                       op(tud.Lu[:, :, 0]), op(tud.Ld)), 3)

    def member():
        t = tud_fn(x, od_fn(T, p, pl, vmr), T)
        return op(t.tau[:, :, 0]), op(t.Lu[:, :, 0]), op(t.Ld)

    ms["member (od+tud+reduce)"], _ = cuda_ms(member, 3)
    t0 = time.perf_counter()
    for _ in range(3):
        member()
        torch.cuda.synchronize()
    ms["member host wall"] = (time.perf_counter() - t0) / 3 * 1e3
    slot_points = {m: 0 for m in fused_xsect.MODES}
    for lay, dplan, mode in od_fn.calls:
        slot_points[mode] += (lay.numel() * int(dplan.counts.sum())
                              * dplan.block * dplan.tile)
    print(f"[6 breakdown] full-width plan build {build_s:.3f} s; one member "
          f"(std atmosphere), ms per stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; plan (layer x slot x point) counts per mode {slot_points} "
          f"[{card}]", flush=True)


def main():
    card, name = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    warm_up(dev)
    k1 = phase_k1(dev, card)
    k2 = phase_k2(dev, card)
    launches = phase_main(card)
    phase_breakdown(dev, card)
    src = "radtxfr_tpu_torch/csrc/"
    kernels = [
        {"name": f"fused_xsect_{m}", "route": "cuda",
         "source": src + "fused_xsect.cu",
         "replaces": "radtxfr_tpu/kernels/pallas_xsect.py:710",
         "launches": launches[m], **k1[m]}
        for m in fused_xsect.MODES]
    kernels.append({"name": "fused_tud", "route": "cuda",
                    "source": src + "fused_tud.cu",
                    "replaces": "radtxfr_tpu/kernels/pallas_tud.py:81",
                    "launches": launches["tud"], **k2})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
