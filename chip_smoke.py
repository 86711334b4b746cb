#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``radtxfr_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing its result on its own line:

1. Device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives.
2. Build: compile the CUDA kernels of ``radtxfr_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and print ptxas's registers and spills.
3. K1 (``csrc/fused_xsect.cu``) against its plain PyTorch version on every
   pass of the production OD builder over a 700-740 cm^-1 sub-band at
   5e-4 cm^-1 (derived line list, 66 layers, line mixing): error <= 2e-6
   of the peak of the line OD of the pass's layers (the float32 bound of
   the JAX package's Pallas OD, README.md "≤2e-6 of peak"), and within
   ``K1_OWN_BOUND`` of the pass's own output peak, so a pass that writes
   zeros or a wrong shape fails whatever the other passes add.
3b. K1 ``full`` and K3 (``csrc/fused_xsect_jvp.cu``) against their plain
   versions on every pass of the differentiable builder on the same
   sub-band: the primal within 2e-6 of its own peak; the tangent within
   2e-6 of its own peak (``K3_BOUND``: a tenth of the JAX package's
   float32 JVP bound) for a T direction over all layers, the H2O-column
   direction and a batch of 8 one-hot T directions.
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
5b. The Jacobian path: ``run_tud`` on the production configuration with
   ``--jacobian`` (d tau/Lu/Ld / d T, H2O, O3: 198 directions) with the
   launch counts reset before and read after (K1 ``full`` and K3 must have
   run); the six Jacobians' shapes, finite values, wall seconds and peak
   device memory. Then the same on a 5 cm^-1 band (at 5e-3 cm^-1) on the
   card and on the CPU: each Jacobian within 1e-4 of its own peak.
6. Where one member's time goes (CUDA events per stage), with each K1
   mode's bound at the production width.
6b. Where one 8-direction tangent batch of the Jacobian goes.

Each kernel's bound is the larger of its bytes over 3.35 TB/s and its
operations over the card's rate for them (67 TFLOP/s FP32; K2's
exponentials also over the special-function units), with the evaluations
the kernel needs recounted on the host from the plans and the line
parameters (``window_counts``).

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
from radtxfr_tpu_torch.core.planck import planckian  # noqa: E402
from radtxfr_tpu_torch.products.od import make_od_fn  # noqa: E402
from radtxfr_tpu_torch.products.tud import (_layers_below,  # noqa: E402
                                            downwelling_quadrature,
                                            make_tud_fn, tud_from_od)
from radtxfr_tpu_torch.sensor.resolution import reduce_operator  # noqa: E402

ALTITUDES = [0.061, 0.305, 1.524, 3.048, 6.096, 9.144, 12.192, 15.24, 500.0]
PRODUCTION = ("tud --derived --line-mixing --continuum mt_ckd --numin 690 "
              "--numax 1410 --dv 0.0005 --n-atmos 4 --batch 2")
PRODUCTION_MODES = ("asym", "core", "mix")
K1_BOUND = 2e-6
# and of the pass's own output peak: the core pass is a difference of two
# near-equal float32 line shapes (Weideman - asym) in the high-pressure
# layers, so rounding there is ~1e-2 of its own small peak (PERF.md)
K1_OWN_BOUND = {"asym": 2e-6, "core": 5e-2, "mix": 2e-6, "full": 2e-6}
# the JAX package's float32 JVP bound is 2e-5 of peak
# (tests/test_pallas_xsect.py:340); K3 measured <= 3.9e-7 against its plain
# version on the card (PERF.md), so the check holds it to 2e-6
K3_BOUND = 2e-6
K2_BOUND = 5e-6
SLICE_BOUND = 1e-5
JAC_SLICE_BOUND = 1e-4
SUB_BAND = (700.0, 740.0, 0.0005)
FULL_BAND = (690.0, 1410.0, 0.0005)
MARGIN = 25.0           # cm^-1 of lines beyond each band edge (the CLI's)

# The card's peaks (NVIDIA H100 SXM data sheet):
# device memory, FP32 outside the tensor cores, and the special-function
# units' exp2 (16 results per clock per SM on compute capability 9.0, CUDA
# C Programming Guide throughput table, x 132 SMs x 1.98 GHz boost).
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SFU_OPS_PER_S = 16 * 132 * 1.98e9
N_WEI = 16
# lane-ops per evaluation (a*b+c = 2), (inside |x| + y < 15, outside), from
# the hand counts in the CUDA sources: the region test branches per point,
# so an evaluation outside the core pays the asymptotic form only
K1_OPS = {"asym": (28, 28), "core": (175, 14), "mix": (173, 36),
          "full": (157, 31)}


def one_hot_batch(dev):
    """The 8 one-hot T directions of layers 24-31 (one Jacobian batch)."""
    return torch.eye(66, device=dev)[24:32]


def k3_ops(nd):
    """K3's (in-core, outside) lane-ops per evaluation for nd directions
    (csrc/fused_xsect_jvp.cu)."""
    return 48 + 16 * N_WEI + 8 * nd, 54 + 8 * nd


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


def time_kernels(launches, reps=10):
    """(ms, output) of each named kernel launch, all timed before any plain
    version runs (a plain version's seconds of heavy memory traffic would
    otherwise sit just ahead of a sub-millisecond timing); each launched
    again and required bit-identical."""
    out = []
    for name, fn in launches:
        ms, got = cuda_ms(fn, reps)
        check(torch.equal(got, fn()),
              f"{name}: two launches on the same inputs differ")
        out.append((ms, got))
    return out


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
    _build.library()
    print(f"[2 build] {len(_build.build())} libraries under "
          f"{os.path.relpath(_build.BUILD_DIR)} built (in parallel) and "
          f"loaded in {time.perf_counter() - t0:.3f} s", flush=True)
    for line in _build.build_log().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line \
                or "Compiling entry" in line:
            print(f"[2 build] {line.strip()}", flush=True)


def window_counts(lay, dplan, prm, live=None):
    """The evaluations one pass needs, recounted on the host from its plan
    and the line parameters: (in-window, in-core) (layer, line, point)
    triples, and the number of distinct lines it reads. ``live`` (nLay, L)
    bool keeps only the pairs K3 evaluates (a non-zero tangent)."""
    line = dplan.line.cpu().numpy()
    valid = line >= 0
    tile, block = dplan.tile, dplan.block
    counts = dplan.counts.cpu().numpy().astype(np.int64)
    tile_of = np.repeat(np.arange(dplan.n_tiles), counts * block)[valid]
    g = line[valid]
    c = (dplan.k_line.cpu().numpy()[valid].astype(np.float64)
         + dplan.frac0.cpu().numpy()[valid].astype(np.float64))
    lo_t = tile_of * tile
    hi_t = np.minimum(lo_t + tile, dplan.n_out) - 1
    wcap = dplan.wcap.cpu().numpy()[valid].astype(np.float64)
    host = {k: getattr(prm, k).detach().cpu().numpy().astype(np.float64)
            for k in ("wing", "gamma_d", "gamma_0", "shift0")}
    n_win = n_core = 0
    for li in lay.cpu().numpy():
        w = np.minimum(host["wing"][li, g], wcap) / dplan.dx
        # integers k with c - w < k <= c + w inside the slot's tile
        lo = np.maximum(np.floor(c - w) + 1, lo_t)
        hi = np.minimum(np.floor(c + w), hi_t)
        keep = hi >= lo
        if live is not None:
            keep &= live[li, g]
        n_win += int((hi - lo + 1)[keep].sum())
        # and |x| + y < 15: |k - c - ds| < (15 - y) / xs
        cte = np.sqrt(np.log(2.0)) / host["gamma_d"][li, g]
        y = host["gamma_0"][li, g] * cte
        r = (15.0 - y) / (dplan.dx * cte)
        mid = c + host["shift0"][li, g] / dplan.dx
        clo = np.maximum(np.floor(mid - r) + 1, lo)
        chi = np.minimum(np.ceil(mid + r) - 1, hi)
        kc = keep & (y < 15.0) & (chi >= clo)
        n_core += int((chi - clo + 1)[kc].sum())
    return n_win, n_core, int(np.unique(g).size)


def bound(ops, nbytes, sfu=0):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over their peak rates."""
    t_ops = max(ops / FP32_OPS_PER_S, sfu / SFU_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def k1_bound_work(mode, lay, dplan, prm, counts=None):
    """(lane-ops, bytes) one K1 pass needs on these inputs: every needed
    evaluation at its region's hand count; each parameter of the lines it
    reads, each plan slot and each output element once. ``counts``: the
    pass's ``window_counts``, when already taken."""
    n_win, n_core, n_lines = counts or window_counts(lay, dplan, prm)
    ops_in, ops_out = K1_OPS[mode]
    n_par = 6 if mode == "mix" else 5
    nl = lay.numel()
    nbytes = (4 * n_par * nl * n_lines + 16 * dplan.k_line.numel()
              + 4 * nl * dplan.n_out)
    return n_core * ops_in + (n_win - n_core) * ops_out, nbytes


def k3_bound_work(lay, dplan, prm, tangents):
    """(lane-ops, bytes) of one K3 launch set for the (nd, nLay, L)
    tangents: the live evaluations only, as the kernel skips the rest."""
    nd = tangents[0].shape[0]
    live = np.zeros(tuple(prm.strength.shape), dtype=bool)
    for t in tangents:
        live |= (t != 0).any(dim=0).cpu().numpy()
    n_win, n_core, n_lines = window_counts(lay, dplan, prm, live)
    ops_in, ops_out = k3_ops(nd)
    nl = lay.numel()
    nbytes = (4 * (5 + 4 * nd) * nl * n_lines + 16 * dplan.k_line.numel()
              + 4 * nd * nl * dplan.n_out)
    return n_core * ops_in + (n_win - n_core) * ops_out, nbytes


def phase_k1(dev, card):
    f32 = torch.float32
    store = derived_lwir_linelist(SUB_BAND[0] - MARGIN, SUB_BAND[1] + MARGIN,
                                  device=dev, dtype=f32)
    iso = IsoTables.load(device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(*SUB_BAND)
    y = y_air_for_store(store.host_view())
    od_fn = make_od_fn(store, iso, X, base, continuum="mt_ckd",
                       line_mixing={"y_air": y})
    prm, Y = od_fn.line_params(base.T, base.p, base.pl, base.vmr)
    line_od = torch.zeros((base.n_layers, X.size), dtype=f32, device=dev)
    runs = []
    timed = time_kernels(
        (f"K1 {call[2]}", lambda call=call: od_fn.run_call(call, prm, Y))
        for call in od_fn.calls)
    for call, (k_ms, k_out) in zip(od_fn.calls, timed):
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
        add_stats(stats, mode, err, k_ms, p_ms,
                  *k1_bound_work(mode, lay, dplan, prm))
    check(set(stats) == set(PRODUCTION_MODES),
          f"K1 sub-band exercised modes {sorted(stats)}")
    return finish_stats(stats)


def add_stats(stats, name, err, k_ms, p_ms, ops, nbytes, sfu=0):
    s = stats.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                "plain_ms": 0.0, "ops": 0, "bytes": 0,
                                "sfu": 0})
    s["max_abs_err"] = max(s["max_abs_err"], err)
    s["ms"] += k_ms
    s["plain_ms"] += p_ms
    s["ops"] += ops
    s["bytes"] += nbytes
    s["sfu"] += sfu


def finish_stats(stats):
    """The JSON fields of each kernel: errors, times, and the bound of the
    work those times cover."""
    out = {}
    for name, s in stats.items():
        b_ms, b_by = bound(s["ops"], s["bytes"], s["sfu"])
        out[name] = {"max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None}
    return out


def t_tangents(od_fn, base, V):
    """Line-parameter tangents, each (nd, nLay, L), of the T directions
    ``V`` (nd, nLay) at the state ``base``."""
    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr

    def prm_of(T_):
        prm = od_fn.line_params(T_, p, pl, vmr)[0]
        return prm.shift0, prm.strength, prm.gamma_d, prm.gamma_0

    return torch.func.vmap(
        lambda v: torch.func.jvp(prm_of, (T,), (v,))[1])(V)


def phase_k1_diff(dev, card):
    """K1 'full' and K3 against their plain versions on every pass of the
    differentiable builder on the sub-band."""
    f32 = torch.float32
    store = derived_lwir_linelist(SUB_BAND[0] - MARGIN, SUB_BAND[1] + MARGIN,
                                  device=dev, dtype=f32)
    iso = IsoTables.load(device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(*SUB_BAND)
    od_fn = make_od_fn(store, iso, X, base, continuum="mt_ckd",
                       differentiable=True)
    check({c[2] for c in od_fn.calls} == {"full"},
          "the differentiable builder must plan 'full' passes only")
    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr
    prm = od_fn.line_params(T, p, pl, vmr)[0]
    n_lay = base.n_layers
    # tangent sets: a T direction over all layers, the H2O column and
    # 8 one-hot T directions (layers 24-31), each as (nd, nLay, L)
    h2o = torch.zeros_like(vmr)
    h2o[:, 0] = vmr[:, 0]

    def prm_of_vmr(v):
        q = od_fn.line_params(T, p, pl, v)[0]
        return q.shift0, q.strength, q.gamma_d, q.gamma_0

    sets = {
        "T linspace(0.5, 1.5)": t_tangents(
            od_fn, base, torch.linspace(0.5, 1.5, n_lay, device=dev)[None]),
        "H2O column": tuple(t[None] for t in torch.func.jvp(
            prm_of_vmr, (vmr,), (h2o,))[1]),
        "8 one-hot T (layers 24-31)": t_tangents(od_fn, base,
                                                 one_hot_batch(dev)),
    }
    sets = {k: [t.contiguous() for t in v] for k, v in sets.items()}
    launches = []
    for lay, dplan, _ in od_fn.calls:
        args = (dplan, lay, prm.shift0, prm.strength, prm.gamma_d,
                prm.gamma_0, prm.wing)
        launches.append(("K1 full", lambda args=args: fused_xsect.xsect_fused(
            *args, None, "full", N_WEI)))
        launches += [(f"K3 {name}", lambda args=args, tans=tans:
                      fused_xsect.xsect_fused_jvp(*args, *tans, N_WEI))
                     for name, tans in sets.items()]
    timed = iter(time_kernels(launches))
    stats, jvp_err = {}, 0.0
    for call in od_fn.calls:
        lay, dplan, _ = call
        args = (dplan, lay, prm.shift0, prm.strength, prm.gamma_d,
                prm.gamma_0, prm.wing)
        k_ms, k_out = next(timed)
        p_ms, p_out = cuda_ms(lambda: fused_xsect.xsect_fused_plain(
            *args, None, "full", N_WEI), 1)
        err = (k_out - p_out).abs().max().item()
        own = p_out.abs().max().item()
        check(own > 0.0, "K1 full: the plain pass is zero on the band")
        print(f"[3b K1 full] layers {lay.numel()} tile {dplan.tile} block "
              f"{dplan.block} tiles {dplan.n_tiles}: max|kernel-plain| "
              f"{err:.3e} = {err / own:.3e} of the pass's peak {own:.4e}; "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms [{card}]",
              flush=True)
        check(err / own <= K1_OWN_BOUND["full"],
              f"K1 full: {err / own:.3e} of peak > {K1_OWN_BOUND['full']}")
        add_stats(stats, "full", err, k_ms, p_ms,
                  *k1_bound_work("full", lay, dplan, prm))
        for name, tans in sets.items():
            k_ms, k_t = next(timed)
            p_ms, p_t = cuda_ms(lambda: fused_xsect.xsect_fused_jvp_plain(
                *args, *tans, N_WEI), 1)
            err = (k_t - p_t).abs().max().item()
            own = p_t.abs().max().item()
            # a pass none of whose layers the directions touch is zero
            touched = any(bool((t != 0).any(dim=0).any(dim=1)[lay.long()]
                               .any()) for t in tans)
            check((own > 0.0) == touched, f"K3 {name}: the plain tangent "
                  f"is {'zero' if touched else 'non-zero'}")
            rel = err / own if touched else err
            print(f"[3b K3 {name}] layers {lay.numel()}, {k_t.shape[0]} "
                  f"direction(s): max|kernel-plain| {err:.3e} = "
                  f"{rel:.3e} of the tangent's peak {own:.4e}; kernel "
                  f"{k_ms:.4f} ms, plain {p_ms:.3f} ms [{card}]", flush=True)
            check(rel <= K3_BOUND if touched else err == 0.0,
                  f"K3 {name}: {rel:.3e} of peak > {K3_BOUND}")
            jvp_err = max(jvp_err, err)
            if name.startswith("8"):
                # the Jacobian's batch shape carries the times and bound
                add_stats(stats, "jvp", err, k_ms, p_ms,
                          *k3_bound_work(lay, dplan, prm, tans))
    stats["jvp"]["max_abs_err"] = jvp_err
    return finish_stats(stats)


def phase_k2(dev, card):
    f32 = torch.float32
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(*FULL_BAND)
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
    # per column and layer: two expm1 (Planck, both passes), one exp per
    # secant and one per downwelling angle, each one special-function op;
    # lane-ops by hand: expm1f ~20, expf ~8, each carry update ~5
    n_x, n_l, n_zs, n_mu, n_a = X.size, base.n_layers, len(ALTITUDES), 1, 30
    sfu = n_x * (n_l * (2 + n_mu + n_a) + n_zs * n_mu)
    ops = n_x * n_l * (2 * (20 + 5) + (n_mu + n_a) * (8 + 5))
    nbytes = 4 * (n_l * n_x + n_x + n_l) + 4 * n_x * (2 * n_zs * n_mu + 1)
    stats = {}
    add_stats(stats, "tud", err_max, k_ms, p_ms, ops, nbytes, sfu)
    out = finish_stats(stats)["tud"]
    print(f"[4 K2] bound {out['bound_ms']:.4f} ms ({out['bound_by']}: "
          f"{sfu:.4g} special-function ops at {SFU_OPS_PER_S:.4g}/s, "
          f"{ops:.4g} lane-ops at {FP32_OPS_PER_S:.4g}/s, {nbytes:.4g} B "
          f"at {HBM_BYTES_PER_S:.4g} B/s) [{card}]", flush=True)
    return out


def reset_launches():
    for k in fused_xsect.LAUNCHES:
        fused_xsect.LAUNCHES[k] = 0
    fused_tud.LAUNCHES["tud"] = 0


def read_launches():
    return dict(fused_xsect.LAUNCHES, tud=fused_tud.LAUNCHES["tud"])


def phase_main(card):
    args = build_parser().parse_args(PRODUCTION.split())
    timings = {}
    reset_launches()
    x_lo, out = run_tud(args, "cuda", timings)
    launches = read_launches()
    print(f"[5 main] launches during run_tud: {launches}", flush=True)
    for k in (*PRODUCTION_MODES, "tud"):
        check(launches[k] > 0, f"kernel {k} was not launched by the main "
              "path")
    n, n_out, n_zs = args.n_atmos, x_lo.size, len(args.altitudes)
    n_x = arange_drift_free(args.numin, args.numax, args.dv).size
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
    print(f"[5 main] {n} members x {n_x} points -> {n_out} x {n_zs}: "
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


JAC_KEYS = [f"d{prod}_d{var}" for var in ("T", "H2O", "O3")
            for prod in ("tau", "Lu", "Ld")]


def phase_jacobian(card):
    """The Jacobian path at full width, then a small band card vs CPU."""
    args = build_parser().parse_args((PRODUCTION + " --jacobian").split())
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    x_lo, out = run_tud(args, "cuda", timings)
    launches = read_launches()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[5b jacobian] launches during run_tud --jacobian: {launches}",
          flush=True)
    for k in ("full", "jvp"):
        check(launches[k] > 0, f"kernel {k} was not launched by the "
              "Jacobian path")
    n_out, n_zs, n_lay = x_lo.size, len(args.altitudes), 66
    n_x = arange_drift_free(args.numin, args.numax, args.dv).size
    for k in JAC_KEYS:
        a = out[k]
        want = (n_out, n_lay) if k.startswith("dLd") else (n_out, n_zs, n_lay)
        check(a.shape == want, f"{k} has shape {a.shape}, expected {want}")
        check(np.isfinite(a).all(), f"{k} has non-finite values")
        check(np.abs(a).max() > 0.0, f"{k} is zero")
    n_dir = 3 * n_lay
    print(f"[5b jacobian] {n_dir} directions x {n_x} points -> "
          f"{n_out} x {n_zs} x {n_lay}: Jacobian {timings['jacobian_s']:.3f}"
          f" s wall ({timings['jacobian_s'] / n_dir:.4f} s per direction), "
          f"peak device memory {peak_gib:.3f} GiB; members "
          f"{timings['members_s']:.3f} s, plan build {timings['build_s']:.3f}"
          f" s; peaks " + ", ".join(f"{k} {np.abs(out[k]).max():.4g}"
                                    for k in JAC_KEYS) + f" [{card}]",
          flush=True)

    small = build_parser().parse_args(
        "tud --derived --line-mixing --continuum mt_ckd --numin 718 "
        "--numax 723 --dv 0.005 --n-atmos 1 --batch 1 --jacobian".split())
    t0 = time.perf_counter()
    _, gpu = run_tud(small, "cuda")
    t1 = time.perf_counter()
    _, cpu = run_tud(small, "cpu")
    t2 = time.perf_counter()
    for k in JAC_KEYS:
        rel = np.abs(gpu[k] - cpu[k]).max() / np.abs(cpu[k]).max()
        print(f"[5b slice] 718-723 cm^-1 at 5e-3, {k}: card vs CPU plain "
              f"{rel:.3e} of peak", flush=True)
        check(rel <= JAC_SLICE_BOUND, f"slice {k}: {rel:.3e} > "
              f"{JAC_SLICE_BOUND}")
    print(f"[5b slice] run_tud --jacobian: card {t1 - t0:.3f} s, CPU "
          f"{t2 - t1:.3f} s", flush=True)
    return launches


def phase_breakdown(dev, card):
    f32 = torch.float32
    store = derived_lwir_linelist(FULL_BAND[0] - MARGIN, FULL_BAND[1] + MARGIN,
                                  device=dev, dtype=f32)
    iso = IsoTables.load(device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(*FULL_BAND)
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
    slot_points = {m: 0 for m in PRODUCTION_MODES}
    work = {m: [0, 0] for m in PRODUCTION_MODES}
    prm, _ = od_fn.line_params(T, p, pl, vmr)
    for lay, dplan, mode in od_fn.calls:
        slot_points[mode] += (lay.numel() * int(dplan.counts.sum())
                              * dplan.block * dplan.tile)
        counts = window_counts(lay, dplan, prm)
        n_win, n_core, _ = counts
        ops, nbytes = k1_bound_work(mode, lay, dplan, prm, counts)
        work[mode] = [work[mode][0] + ops, work[mode][1] + nbytes]
        print(f"[6 evaluations] {mode} pass, {lay.numel()} layers: "
              f"in-window {n_win:.4g}, in-core {n_core:.4g}", flush=True)
    print(f"[6 breakdown] full-width plan build {build_s:.3f} s; one member "
          f"(std atmosphere), ms per stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; plan (layer x slot x point) counts per mode {slot_points} "
          f"[{card}]", flush=True)
    print("[6 bounds] per member, K1 bound ms: " + ", ".join(
        "{} {:.4f} ({})".format(m, *bound(*w)) for m, w in work.items())
        + f" [{card}]", flush=True)


def phase_jac_breakdown(dev, card):
    """Where one 8-direction tangent batch of the full-width Jacobian goes
    (standard atmosphere, one-hot T directions on layers 24-31)."""
    f32 = torch.float32
    store = derived_lwir_linelist(FULL_BAND[0] - MARGIN, FULL_BAND[1] + MARGIN,
                                  device=dev, dtype=f32)
    iso = IsoTables.load(device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(*FULL_BAND)
    grid = torch.as_tensor(X, dtype=f32, device=dev)
    alts = torch.as_tensor(ALTITUDES, dtype=f32, device=dev)
    od_fn = make_od_fn(store, iso, grid.cpu().numpy(), base,
                       continuum="mt_ckd", differentiable=True)
    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr
    V = one_hot_batch(dev)
    vjvp = lambda f, x: torch.func.vmap(  # noqa: E731
        lambda v: torch.func.jvp(f, (x,), (v,)), out_dims=(None, 0))(V)
    ms = {}
    ms["line params + tangents"], tans = cuda_ms(
        lambda: t_tangents(od_fn, base, V), 3)
    tans = [t.contiguous() for t in tans]
    prm = od_fn.line_params(T, p, pl, vmr)[0]
    ms["K1 full"] = ms["K3 (8 dirs)"] = 0.0
    work = {"full": [0, 0], "jvp": [0, 0]}
    for lay, dplan, _ in od_fn.calls:
        args = (dplan, lay, prm.shift0, prm.strength, prm.gamma_d,
                prm.gamma_0, prm.wing)
        t, _ = cuda_ms(lambda: fused_xsect.xsect_fused(
            *args, None, "full", N_WEI), 3)
        ms["K1 full"] += t
        t, _ = cuda_ms(lambda: fused_xsect.xsect_fused_jvp(
            *args, *tans, N_WEI), 3)
        ms["K3 (8 dirs)"] += t
        for k, (o, b) in (("full", k1_bound_work("full", lay, dplan, prm)),
                          ("jvp", k3_bound_work(lay, dplan, prm, tans))):
            work[k] = [work[k][0] + o, work[k][1] + b]
    ms["continuum + tangents"], _ = cuda_ms(
        lambda: vjvp(lambda T_: od_fn.cont(T_, p, pl, vmr), T), 3)
    ms["OD + tangents"], (od, od_t) = cuda_ms(
        lambda: vjvp(lambda T_: od_fn(T_, p, pl, vmr), T), 1)
    B, B_t = vjvp(lambda T_: planckian(grid, T_).transpose(0, 1), T)

    def tud3(o, b):
        t = tud_from_od(grid, o, b, base.z0, alts, n_angles=30)
        return t.tau, t.Lu, t.Ld

    ms["tud_from_od primal"], _ = cuda_ms(lambda: tud3(od, B), 3)
    ms["tud_from_od + tangents"], tan = cuda_ms(
        lambda: torch.func.vmap(lambda ot, bt: torch.func.jvp(
            tud3, (od, B), (ot, bt))[1])(od_t, B_t), 1)
    op = reduce_operator(X, 0.25, device=dev)
    ms["reduce (8 dirs)"], _ = cuda_ms(
        lambda: [op(a.movedim(0, -1)) for a in tan], 3)

    def forward(T_):
        o = od_fn(T_, p, pl, vmr)
        return tud3(o, planckian(grid, T_).transpose(0, 1))

    torch.cuda.reset_peak_memory_stats()
    ms["batch (jvp of the forward + reduce)"], _ = cuda_ms(
        lambda: [op(a.movedim(0, -1)) for a in vjvp(forward, T)[1]], 1)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print("[6b jacobian batch] 8 one-hot T directions at full width, ms per "
          "stage: " + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; peak device memory of a batch {peak_gib:.3f} GiB; bound ms: "
          + ", ".join("{} {:.4f} ({})".format(k, *bound(*w))
                      for k, w in work.items()) + f" [{card}]", flush=True)


def main():
    card, name = phase_device()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    phase_build()
    warm_up(dev)
    k1 = phase_k1(dev, card)
    k1d = phase_k1_diff(dev, card)
    k2 = phase_k2(dev, card)
    launches = phase_main(card)
    jac_launches = phase_jacobian(card)
    phase_breakdown(dev, card)
    phase_jac_breakdown(dev, card)
    src = "radtxfr_tpu_torch/csrc/"
    xs = "radtxfr_tpu/kernels/pallas_xsect.py:"
    kernels = [
        {"name": f"fused_xsect_{m}", "route": "cuda",
         "source": src + "fused_xsect.cu", "replaces": xs + "710",
         "launches": launches[m], **k1[m]}
        for m in PRODUCTION_MODES]
    kernels.append({"name": "fused_xsect_full", "route": "cuda",
                    "source": src + "fused_xsect.cu", "replaces": xs + "710",
                    "launches": jac_launches["full"], **k1d["full"]})
    kernels.append({"name": "fused_xsect_jvp", "route": "cuda",
                    "source": src + "fused_xsect_jvp.cu",
                    "replaces": xs + "1212",
                    "launches": jac_launches["jvp"], **k1d["jvp"]})
    kernels.append({"name": "fused_tud", "route": "cuda",
                    "source": src + "fused_tud.cu",
                    "replaces": "radtxfr_tpu/kernels/pallas_tud.py:81",
                    "launches": launches["tud"], **k2})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
