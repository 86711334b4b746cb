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
3c. The XS lattice's K1 modes (``sdvoigt*``, ``lorentz``, ``doppler``,
   ``corr:64:*``) against their plain versions on every pass of
   ``make_xsect_fn`` over a 1000-1010 cm^-1 sub-band at 0.0025 (the
   bench's 30,000-line synthetic list, 10 states, 350 cm^-1 wings): the
   coarse-far route, ``far_method="classic"``, ``two_pass=False``
   (``sdvoigt``), the Lorentz and Doppler builds and direct
   ``corr:64:{voigt,sdvoigt}full`` launches; each pass within
   ``XS_BOUND`` of the lattice's peak and within ``XS_OWN_BOUND`` of its
   own peak; coarse against classic within 1e-5 (SD-Voigt) and 1e-6
   (Voigt) of peak.
7. The ``xsect`` CLI at full width (``XS_CLI``: 2,680,001 points, 10
   states) with the launch counts reset before and read after (the
   coarse, correction and SD core passes must have run): finite, AFIT
   files written and one read back, plan-build and wall seconds, states
   per second and nominal hapi-window evaluations per second; the same
   lattice built with ``far_method="classic"`` (no coarse grid, correction
   or upsample) holds it within 1e-5 of peak at full width. Then the
   bench's configuration through ``make_xsect_fn``, the ``--profile
   lorentz|doppler`` and ``two_pass=False`` lattices on the sub-band (each
   with its own counts), and a small lattice on the card and on the CPU
   (plain versions) within 1e-5 of peak.
8. Where the full-width lattice's time goes (CUDA events per stage), with
   each mode's bound.

Each kernel's bound is the larger of its bytes over 3.35 TB/s and its
operations over the card's rate for them (67 TFLOP/s FP32; K2's
exponentials also over the special-function units), with the evaluations
the kernel needs recounted on the host from the plans and the line
parameters (``window_counts``).

It ends with one JSON line of kernel results and, last, the device line.
Any failed check raises; the script then exits non-zero without the last
line. There is no CPU fallback.
"""

import collections
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from radtxfr_tpu_torch import _build  # noqa: E402
from radtxfr_tpu_torch.atmos.profile import std_atmosphere  # noqa: E402
from radtxfr_tpu_torch.cli.main import (build_parser, run_tud,  # noqa: E402
                                        run_xsect, write_xs)
from radtxfr_tpu_torch.io.afit_xs import xs_read  # noqa: E402
from radtxfr_tpu_torch.kernels.lineparams import (  # noqa: E402
    compute_line_params)
from radtxfr_tpu_torch.lines.synthetic import synthetic_lines  # noqa: E402
from radtxfr_tpu_torch.core.grid import arange_drift_free  # noqa: E402
from radtxfr_tpu_torch.kernels import fused_tud, fused_xsect  # noqa: E402
from radtxfr_tpu_torch.kernels.linemixing_data import (  # noqa: E402
    y_air_for_store)
from radtxfr_tpu_torch.lines.derived import derived_lwir_linelist  # noqa: E402
from radtxfr_tpu_torch.lines.store import IsoTables  # noqa: E402
from radtxfr_tpu_torch.core.planck import planckian  # noqa: E402
from radtxfr_tpu_torch.products.od import (_coarse_upsample,  # noqa: E402
                                           make_od_fn, make_xsect_fn)
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


# the XS lattice (reference configuration 2; the JAX bench's metric 4,
# bench.py:588-619): the CLI run at full width, the bench's list and tile
XS_CLI = ("xsect --synthetic 30000 --numin 400 --numax 7100 --dv 0.0025 "
          "--profile sdvoigt --wing-abs 350 --T 275 --T-max 320 --T-step 5 "
          "--p 1.0")
XS_BENCH = dict(n_lines=30_000, nu_min=400.0, nu_max=7100.0, seed=1,
                sd_zero_frac=0.25, tile=8192)
XS_SUB = (1000.0, 1010.0, 0.0025)
XS_T = np.arange(275.0, 321.0, 5.0)          # 10 states at 1 atm
XS_WING = 350.0
XS_MODES = ("sdvoigt", "sdvoigt_asym", "sdvoigt_core", "lorentz", "doppler",
            "corr:64:voigt", "corr:64:voigtfull", "corr:64:sdvoigt",
            "corr:64:sdvoigtfull")
# each XS pass against its plain version, of the lattice's peak (the JAX
# package's float32 Pallas bound) and of the pass's own peak: the core and
# correction passes are differences (full - asym; point term - cubic
# interpolation of the same far field), so rounding is a larger share of
# their own small peaks, as for the Voigt core pass (measured <= 1.1e-7
# sdvoigt_core and <= 1.4e-6 corr, PERF.md)
XS_BOUND = 2e-6
XS_OWN_BOUND = {"asym": 2e-6, "core": 5e-2, "full": 2e-6, "sdvoigt": 2e-6,
                "sdvoigt_asym": 2e-6, "sdvoigt_core": 1e-5, "lorentz": 2e-6,
                "doppler": 2e-6, "corr:64:voigt": 1e-5,
                "corr:64:voigtfull": 1e-5, "corr:64:sdvoigt": 1e-5,
                "corr:64:sdvoigtfull": 1e-5}
COARSE_BOUND = {"sdvoigt": 1e-5, "voigt": 1e-6}
XS_SLICE_BOUND = 1e-5
# SD-Voigt lane-ops per evaluation, from the building blocks in the header
# of csrc/fused_xsect.cu ("Bound."): (inside the radius where a CPF point
# can reach |Z| < 15, counted at two Weideman points; outside it, where
# both points take the unguarded asymptotic form)
SD_BASE = 11 + 24 + 2        # PRE, the SD prelude, the tail
SD_SEL = 22                  # |Z1|, |Z2|, the CPF3 test and its selects
SD_WEI = 3 + 35 + 7 * N_WEI  # region test + Weideman (y elementwise)
SD_ASYM = 3 + 18             # region test + the unguarded asymptotic form
SD_GUARDED = 19              # the guarded asymptotic form
SD_OPS = {"sdvoigt_asym": (SD_BASE + 2 * SD_GUARDED,) * 2,
          "sdvoigt": (SD_BASE + SD_SEL + 2 * SD_WEI,
                      SD_BASE + SD_SEL + 2 * SD_ASYM)}
SD_OPS["sdvoigt_core"] = tuple(n + 2 * (SD_GUARDED + 1)
                               for n in SD_OPS["sdvoigt"])
SIMPLE_OPS = {"lorentz": 18, "doppler": 20}
SPAN = 256            # points of a K1 CTA's slice (csrc: SPAN)
INTERP_OPS = 9        # a correction point's 4-node FMA interpolation + add


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


def slot_tiles(dplan):
    """The tile of each plan slot (-1 past the last tile's blocks: a plan
    with no line in any tile still holds one block of padding)."""
    counts = dplan.counts.cpu().numpy().astype(np.int64)
    t = np.repeat(np.arange(dplan.n_tiles), counts * dplan.block)
    return np.concatenate([t, np.full(dplan.line.numel() - t.size, -1)])


def window_counts(lay, dplan, prm, live=None, cap=True, region="voigt"):
    """The evaluations one pass needs, recounted on the host from its plan
    and the line parameters: (in-window, in-region) (layer, line, point)
    triples, and the number of distinct lines it reads. ``live`` (nLay, L)
    bool keeps only the pairs K3 evaluates (a non-zero tangent); ``cap``
    False masks by the true window (the correction passes); ``region``
    'voigt' is hum1_wei's |x| + y < 15 about the shifted centre, 'sd' the
    SD-Voigt radius within which a CPF point can reach |Z| < 15
    (|dnu - s0| < Gamma2 (225 + 30c + 2c^2), products/od.py's
    sdvoigt_core_bound without its margin)."""
    line = dplan.line.cpu().numpy()
    valid = line >= 0
    tile = dplan.tile
    tile_of = slot_tiles(dplan)[valid]
    g = line[valid]
    c = (dplan.k_line.cpu().numpy()[valid].astype(np.float64)
         + dplan.frac0.cpu().numpy()[valid].astype(np.float64))
    lo_t = tile_of * tile
    hi_t = np.minimum(lo_t + tile, dplan.n_out) - 1
    wcap = dplan.wcap.cpu().numpy()[valid].astype(np.float64)
    host = {k: getattr(prm, k).detach().cpu().numpy().astype(np.float64)
            for k in ("wing", "gamma_d", "gamma_0", "shift0", "gamma_2")}
    n_win = n_core = 0
    for li in lay.cpu().numpy():
        w = host["wing"][li, g]
        w = (np.minimum(w, wcap) if cap else w) / dplan.dx
        # integers k with c - w < k <= c + w inside the slot's tile
        lo = np.maximum(np.floor(c - w) + 1, lo_t)
        hi = np.minimum(np.floor(c + w), hi_t)
        keep = hi >= lo
        if live is not None:
            keep &= live[li, g]
        n_win += int((hi - lo + 1)[keep].sum())
        mid = c + host["shift0"][li, g] / dplan.dx
        gd, g0 = host["gamma_d"][li, g], host["gamma_0"][li, g]
        if region == "voigt":
            # |x| + y < 15: |k - c - ds| < (15 - y) / xs
            cte = np.sqrt(np.log(2.0)) / gd
            y = g0 * cte
            r = (15.0 - y) / (dplan.dx * cte)
            ok = y < 15.0
        else:
            g2 = np.maximum(host["gamma_2"][li, g], 1e-4 * g0 + 1e-12)
            cc = gd / (2.0 * np.sqrt(np.log(2.0)) * g2)
            r = g2 * (225.0 + 30.0 * cc + 2.0 * cc * cc) / dplan.dx
            ok = np.ones_like(r, dtype=bool)
        clo = np.maximum(np.floor(mid - r) + 1, lo)
        chi = np.minimum(np.ceil(mid + r) - 1, hi)
        kc = keep & ok & (chi >= clo)
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


def xs_bound_work(mode, lay, dplan, prm):
    """(lane-ops, bytes) one pass of the XS lattice needs on these inputs:
    its in-window evaluations at their region's hand count; a correction
    pass also interpolates at every point of each of its slots' tiles and
    evaluates (256/R + 3) nodes per slot and 256-point slice."""
    corr = mode.startswith("corr:")
    sd = "sdvoigt" in mode
    n_win, n_reg, n_lines = window_counts(lay, dplan, prm, cap=not corr,
                                          region="sd" if sd else "voigt")
    nl = lay.numel()
    kind = mode
    ops = 0
    if corr:
        _, r_s, variant = mode.split(":")
        kind = {"voigt": "asym", "voigtfull": "full",
                "sdvoigt": "sdvoigt_asym", "sdvoigtfull": "sdvoigt"}[variant]
        tile_of = slot_tiles(dplan)[dplan.line.cpu().numpy() >= 0]
        pts = np.minimum(dplan.tile, dplan.n_out - tile_of * dplan.tile)
        n_nodes = (tile_of.size * -(-dplan.tile // SPAN)
                   * (SPAN // int(r_s) + 3))
        ops = nl * (INTERP_OPS * int(pts.sum())
                    + n_nodes * (SD_OPS["sdvoigt_asym"][0] if sd
                                 else K1_OPS["asym"][0]))
    if kind in SIMPLE_OPS:
        ops_in = ops_out = SIMPLE_OPS[kind]
    else:
        ops_in, ops_out = SD_OPS[kind] if kind in SD_OPS else K1_OPS[kind]
    ops += n_reg * ops_in + (n_win - n_reg) * ops_out
    nbytes = (4 * (6 if sd else 5) * nl * n_lines
              + 16 * dplan.k_line.numel() + 4 * nl * dplan.n_out)
    return ops, nbytes


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


def xs_lines(dev):
    """The bench's synthetic list on ``dev``."""
    spec = {k: XS_BENCH[k] for k in ("n_lines", "nu_min", "nu_max", "seed",
                                     "sd_zero_frac")}
    return synthetic_lines(spec.pop("n_lines"), device=dev,
                           dtype=torch.float32, **spec)


def xs_states(dev):
    T = torch.as_tensor(XS_T, dtype=torch.float32, device=dev)
    return T, torch.ones_like(T)


def check_xs_passes(label, fn, prm, calls, card, stats=None):
    """Each of ``calls`` (state indices, plan, mode) through its kernel
    (all timed first) and its plain version: within XS_BOUND of the
    lattice's peak and XS_OWN_BOUND of its own; the per-mode errors, times
    and bound work go into ``stats`` when given."""
    peak = fn.line_sum(prm).abs().max().item()
    timed = time_kernels((f"K1 {c[2]}", lambda c=c: fn.run_call(c, prm))
                         for c in calls)
    for call, (k_ms, k_out) in zip(calls, timed):
        lay, dplan, mode = call
        p_ms, p_out = cuda_ms(lambda: fn.run_call(
            call, prm, kernel=fused_xsect.xsect_fused_plain), 1)
        err = (k_out - p_out).abs().max().item()
        # a window-edge band may hold no line on the sub-band: then both
        # are zero
        own = p_out.abs().max().item() or 1.0
        check(peak > 0.0 and bool(torch.isfinite(k_out).all()),
              f"{label} {mode}: zero lattice or non-finite pass")
        print(f"[3c {label}] {mode} tile {dplan.tile} block {dplan.block} "
              f"tiles {dplan.n_tiles} points {dplan.n_out}: max|kernel-plain|"
              f" {err:.3e} = {err / peak:.3e} of the lattice's peak "
              f"{peak:.4e} = {err / own:.3e} of the pass's own peak "
              f"{own:.4e}; kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms "
              f"[{card}]", flush=True)
        check(err <= XS_BOUND * peak, f"{label} {mode}: {err / peak:.3e} of "
              f"the lattice's peak > {XS_BOUND}")
        check(err <= XS_OWN_BOUND[mode] * own, f"{label} {mode}: "
              f"{err / own:.3e} of its own peak > {XS_OWN_BOUND[mode]}")
        if stats is not None:
            add_stats(stats, mode, err, k_ms, p_ms,
                      *xs_bound_work(mode, lay, dplan, prm))


def phase_xs_sub(dev, card):
    """3c: every pass of the lattice builders on the 1000-1010 cm^-1
    sub-band; returns the new modes' JSON fields and the launches of the
    direct corr:64:*full runs."""
    store = xs_lines(dev)
    iso = IsoTables.load(device=dev, dtype=torch.float32)
    X = arange_drift_free(*XS_SUB)
    T, p = xs_states(dev)

    def build(**kw):
        return make_xsect_fn(store, iso, X, XS_T, np.ones_like(XS_T),
                             wing_abs=XS_WING, tile=XS_BENCH["tile"], **kw)

    fns = {"sdvoigt coarse": build(profile="sdvoigt"),
           "sdvoigt classic": build(profile="sdvoigt", far_method="classic"),
           "voigt coarse": build(profile="voigt"),
           "voigt classic": build(profile="voigt", far_method="classic"),
           "sdvoigt two_pass=False": build(profile="sdvoigt", two_pass=False),
           "lorentz": build(profile="lorentz"),
           "doppler": build(profile="doppler")}
    main = fns["sdvoigt coarse"]
    check({c[2] for c in main.corr_calls} == {"corr:64:sdvoigt",
                                              "corr:64:voigt"},
          "the sub-band lattice did not take the coarse-far route")
    stats = {}
    # the correction passes' '*full' variants: no builder plans them
    # (products/od.py::_build_coarse_far_calls), so they run directly on
    # the near-zone plans
    full_calls = [(c[0], c[1], c[2] + "full") for c in main.corr_calls[::3]]
    timed = {"sdvoigt coarse": main.all_calls() + full_calls,
             "sdvoigt two_pass=False": None, "lorentz": None,
             "doppler": None}
    for label, fn in fns.items():
        prm = fn.line_params(T, p)
        calls = timed.get(label) or fn.all_calls()
        check_xs_passes(label, fn, prm, calls, card,
                        stats if label in timed else None)
    for prof in ("sdvoigt", "voigt"):
        a = fns[f"{prof} classic"](T, p)
        b = fns[f"{prof} coarse"](T, p)
        rel = ((a - b).abs().max() / a.abs().max()).item()
        print(f"[3c coarse] {prof}: coarse-far vs classic on the card "
              f"{rel:.3e} of peak [{card}]", flush=True)
        check(rel <= COARSE_BOUND[prof], f"coarse {prof}: {rel:.3e} > "
              f"{COARSE_BOUND[prof]}")
    # the direct '*full' launches, counted on their own
    prm = main.line_params(T, p)
    reset_launches()
    for c in full_calls:
        main.run_call(c, prm)
    torch.cuda.synchronize()
    full_launches = read_launches()
    return finish_stats({m: stats[m] for m in XS_MODES}), full_launches


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
    fused_xsect.LAUNCHES.clear()
    fused_tud.LAUNCHES["tud"] = 0


def read_launches():
    """The launches since the last reset, per kernel (0 for any not run)."""
    return collections.Counter(fused_xsect.LAUNCHES,
                               tud=fused_tud.LAUNCHES["tud"])


def phase_main(card):
    args = build_parser().parse_args(PRODUCTION.split())
    timings = {}
    reset_launches()
    x_lo, out = run_tud(args, "cuda", timings)
    launches = read_launches()
    print(f"[5 main] launches during run_tud: {dict(launches)}", flush=True)
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
    print(f"[5b jacobian] launches during run_tud --jacobian: "
          f"{dict(launches)}", flush=True)
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


def window_evals(store, X, T, p, profile, wing_abs):
    """Nominal hapi-window evaluations of a lattice (bench.py's
    _window_evals): the grid points inside each (state, line) window."""
    f64 = dict(device="cpu", dtype=torch.float64)
    lines = type(store).from_numpy(**{k: v for k, v in store.host.items()},
                                   **f64)
    prm = compute_line_params(lines, IsoTables.load(**f64),
                              torch.as_tensor(T, **f64)[:, None],
                              torch.as_tensor(p, **f64)[:, None],
                              wing_abs=wing_abs, profile=profile)
    nu0 = np.broadcast_to(store.host["nu0"], tuple(prm.wing.shape))
    wing = prm.wing.numpy()
    lo = np.searchsorted(X, (nu0 - wing).ravel(), side="right")
    hi = np.searchsorted(X, (nu0 + wing).ravel(), side="right")
    return int((hi - lo).sum())


def xs_args(cmd):
    return build_parser().parse_args(cmd.split())


def phase_xs_main(dev, card):
    """7: the xsect CLI at full width (held against the classic route),
    the bench configuration, the Lorentz/Doppler and single-pass lattices
    (each a path with its own launch counts) and a small lattice on the
    card and the CPU."""
    args = xs_args(XS_CLI)
    timings = {}
    reset_launches()
    xs = run_xsect(args, dev, timings)
    launches = read_launches()
    print(f"[7 xsect] launches during run_xsect: "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    # the CLI's list has sd_air != 0 on every line: the SD-Voigt passes
    for k in ("sdvoigt_asym", "corr:64:sdvoigt", "sdvoigt_core"):
        check(launches[k] > 0, f"kernel {k} was not launched by the xsect "
              "path")
    K, X = xs["K"], xs["X"]
    check(K.shape == (XS_T.size, X.size), f"lattice shape {K.shape}")
    check(np.isfinite(K).all() and K.max() > 0.0,
          "the lattice is not finite and positive somewhere")
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_xs(os.path.join(tmp, "xs"), xs, "radtxfr_tpu synthetic")
        rX, rY, meta = xs_read(paths[3])
        check(len(paths) == XS_T.size and rX.size == X.size
              and np.array_equal(rY, K[3].astype(np.float64))
              and meta["T"] == XS_T[3], "AFIT file read back differs")
    store = synthetic_lines(args.synthetic, nu_min=args.numin - XS_WING,
                            nu_max=args.numax + XS_WING, seed=args.seed,
                            device="cpu")
    evals = window_evals(store, X, xs["T"], xs["p"], "sdvoigt", XS_WING)
    n = XS_T.size
    print(f"[7 xsect] {n} states x {X.size} points, max {K.max():.4e} "
          f"cm^2/molec; plan build {timings['build_s']:.3f} s, lattice "
          f"{timings['run_s']:.3f} s wall ({n / timings['run_s']:.3f} "
          f"states/s, {evals:.4e} nominal window evaluations = "
          f"{evals / timings['run_s']:.4e} /s); AFIT files written and "
          f"read back [{card}]", flush=True)

    # the CLI's lattice against the same lattice on the classic route (each
    # line's whole window on the fine grid, no coarse grid, correction or
    # upsample), so the coarse route's many-tile passes are held at the
    # shapes the CLI launched
    t0 = time.perf_counter()
    classic = make_xsect_fn(type(store).from_numpy(
        **store.host, device=dev, dtype=torch.float32),
        IsoTables.load(device=dev), X, xs["T"], xs["p"], profile="sdvoigt",
        wing_abs=XS_WING, wing_hw=args.wing_hw, far_method="classic")
    build_c = time.perf_counter() - t0
    check(not classic.coarse_calls, "the classic lattice took the coarse "
          "route")
    Tc, pc = (torch.as_tensor(a, dtype=torch.float32, device=dev)
              for a in (xs["T"], xs["p"]))
    ms_c, ref = cuda_ms(lambda: classic(Tc, pc), 1)
    rel = ((torch.as_tensor(K, device=dev) - ref).abs().max()
           / ref.abs().max()).item()
    print(f"[7 xsect] the CLI's coarse-far lattice vs the classic route at "
          f"full width: {rel:.3e} of peak; classic plan build {build_c:.3f} "
          f"s, lattice {ms_c:.3f} ms (CUDA events), passes "
          f"{sorted({c[2] for c in classic.all_calls()})} [{card}]",
          flush=True)
    check(rel <= COARSE_BOUND["sdvoigt"], f"full-width coarse vs classic: "
          f"{rel:.3e} > {COARSE_BOUND['sdvoigt']}")
    del classic, ref

    # the bench's configuration (bench.py:588-619) through make_xsect_fn
    store_b = xs_lines(dev)
    Xb = arange_drift_free(XS_BENCH["nu_min"], XS_BENCH["nu_max"], 0.0025)
    T, p = xs_states(dev)
    t0 = time.perf_counter()
    fn = make_xsect_fn(store_b, IsoTables.load(device=dev), Xb, XS_T,
                       np.ones_like(XS_T), profile="sdvoigt",
                       wing_abs=XS_WING, tile=XS_BENCH["tile"])
    build_s = time.perf_counter() - t0
    reset_launches()
    out = fn(T, p)
    torch.cuda.synchronize()
    bench_launches = read_launches()
    # a quarter of the bench's lines have sd_air = 0: the Voigt passes too
    for k in ("sdvoigt_asym", "asym", "corr:64:sdvoigt", "corr:64:voigt",
              "sdvoigt_core"):
        check(bench_launches[k] > 0, f"kernel {k} was not launched by the "
              "bench configuration")
    check(bool(torch.isfinite(out).all()), "bench lattice not finite")
    ms, _ = cuda_ms(lambda: fn(T, p), 2)
    evals_b = window_evals(store_b, Xb, XS_T, np.ones_like(XS_T), "sdvoigt",
                           XS_WING)
    print(f"[7 bench] make_xsect_fn, 30000 lines seed 1 (25% sd_air = 0), "
          f"{Xb.size} points, tile 8192: launches "
          f"{ {k: v for k, v in bench_launches.items() if v} }; plan build "
          f"{build_s:.3f} s, lattice {ms:.3f} ms (CUDA events, warm), "
          f"{evals_b:.4e} window evaluations = {evals_b / ms * 1e3:.4e} "
          f"sdvoigt_window_evals_per_s [{card}]", flush=True)

    # the single-pass modes: Lorentz and Doppler through the CLI, SD-Voigt
    # without the far-wing split through the builder (sub-band)
    sub = (f"xsect --synthetic 30000 --numin {XS_SUB[0]} --numax "
           f"{XS_SUB[1]} --dv {XS_SUB[2]} --wing-abs {XS_WING} --T 275 "
           f"--T-max 320 --T-step 5 --profile ")
    path_launches = {}
    for prof in ("lorentz", "doppler"):
        reset_launches()
        r = run_xsect(xs_args(sub + prof), dev)
        path_launches[prof] = read_launches()[prof]
        check(path_launches[prof] > 0 and np.isfinite(r["K"]).all(),
              f"xsect --profile {prof} did not run its kernel")
    fn1 = make_xsect_fn(store_b, IsoTables.load(device=dev),
                        arange_drift_free(*XS_SUB), XS_T, np.ones_like(XS_T),
                        profile="sdvoigt", wing_abs=XS_WING, two_pass=False)
    reset_launches()
    check(bool(torch.isfinite(fn1(T, p)).all()), "two_pass=False lattice")
    torch.cuda.synchronize()
    path_launches["sdvoigt"] = read_launches()["sdvoigt"]
    check(path_launches["sdvoigt"] > 0, "two_pass=False ran no sdvoigt pass")
    print(f"[7 paths] launches: lorentz and doppler CLI runs, the "
          f"two_pass=False lattice: {path_launches}", flush=True)

    small = ("xsect --synthetic 2000 --numin 1000 --numax 1010 --dv 0.0025 "
             "--profile sdvoigt --wing-abs 350 --T 275 --T-max 320 "
             "--T-step 5")
    t0 = time.perf_counter()
    gpu = run_xsect(xs_args(small), dev)
    t1 = time.perf_counter()
    cpu = run_xsect(xs_args(small), "cpu")
    t2 = time.perf_counter()
    check(any(m.startswith("corr:") for m in cpu["modes"]),
          "the small lattice did not take the coarse-far route")
    rel = np.abs(gpu["K"] - cpu["K"]).max() / np.abs(cpu["K"]).max()
    print(f"[7 slice] 2000 lines, 1000-1010 cm^-1, 10 states: card vs CPU "
          f"plain {rel:.3e} of peak; card {t1 - t0:.3f} s, CPU "
          f"{t2 - t1:.3f} s", flush=True)
    check(rel <= XS_SLICE_BOUND, f"xsect slice: {rel:.3e} > "
          f"{XS_SLICE_BOUND}")
    # each mode's launches from the first path that ran it: the CLI, the
    # bench configuration, the single-pass lattices
    return {m: path_launches.get(m) or launches[m] or bench_launches[m]
            for m in XS_MODES}


def phase_xs_breakdown(dev, card):
    """8: where the full-width lattice's time goes, per stage."""
    args = xs_args(XS_CLI)
    store = synthetic_lines(args.synthetic, nu_min=args.numin - XS_WING,
                            nu_max=args.numax + XS_WING, seed=args.seed,
                            device=dev)
    X = arange_drift_free(args.numin, args.numax, args.dv)
    fn = make_xsect_fn(store, IsoTables.load(device=dev), X, XS_T,
                       np.ones_like(XS_T), profile="sdvoigt",
                       wing_abs=XS_WING)
    T, p = xs_states(dev)
    ms = {}
    ms["line params"], prm = cuda_ms(lambda: fn.line_params(T, p), 3)

    def passes(calls):
        return [fn.run_call(c, prm) for c in calls]

    ms["coarse passes"], out_c = cuda_ms(lambda: passes(fn.coarse_calls), 3)
    out_c = sum(out_c)
    ms["upsample"], _ = cuda_ms(
        lambda: _coarse_upsample(out_c, fn.n_x, fn.coarse_r), 3)
    ms["corr passes"], _ = cuda_ms(lambda: passes(fn.corr_calls), 3)
    ms["core passes"], _ = cuda_ms(lambda: passes(fn.calls), 3)
    ms["lattice (fn)"], _ = cuda_ms(lambda: fn(T, p), 3)
    work = {}
    for lay, dplan, mode in fn.all_calls():
        o, b = xs_bound_work(mode, lay, dplan, prm)
        w = work.setdefault(mode, [0, 0])
        work[mode] = [w[0] + o, w[1] + b]
    print("[8 xsect breakdown] full width (10 states x "
          f"{X.size} points), ms per stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + "; passes " + ", ".join(
              f"{m} x{sum(c[2] == m for c in fn.all_calls())}"
              for m in work) + f" [{card}]", flush=True)
    print("[8 bounds] per lattice, bound ms: " + ", ".join(
        "{} {:.4f} ({})".format(m, *bound(*w)) for m, w in work.items())
        + f" [{card}]", flush=True)


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
    xs_stats, full_launches = phase_xs_sub(dev, card)
    k2 = phase_k2(dev, card)
    launches = phase_main(card)
    jac_launches = phase_jacobian(card)
    xs_launches = {**phase_xs_main(dev, card),
                   **{m: full_launches[m] for m in ("corr:64:voigtfull",
                                                    "corr:64:sdvoigtfull")}}
    phase_breakdown(dev, card)
    phase_jac_breakdown(dev, card)
    phase_xs_breakdown(dev, card)
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
    kernels += [{"name": f"fused_xsect_{m}", "route": "cuda",
                 "source": src + "fused_xsect.cu", "replaces": xs + "710",
                 "launches": xs_launches[m], **xs_stats[m]}
                for m in XS_MODES]
    kernels.append({"name": "fused_tud", "route": "cuda",
                    "source": src + "fused_tud.cu",
                    "replaces": "radtxfr_tpu/kernels/pallas_tud.py:81",
                    "launches": launches["tud"], **k2})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
