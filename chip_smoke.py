#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``radtxfr_tpu_torch``) once on one NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases, each printing its result on its own line:

1. Device: require CUDA; print the card's name and power limit as
   ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` gives.
2. Build: compile the CUDA kernels of ``radtxfr_tpu_torch/csrc`` (one nvcc
   per source, in parallel) and print ptxas's registers and spills.
2b. The FP32 issue-rate probe (P1/P2, ``csrc/peak_probe.cu``): each mix of
   the suite, at both unrolled depths (8 x 2 and 256 x 2 steps on every
   SM's threads), against its plain chains within 4 float32 ulps, with
   operands that move every step by many ulps (``fp32_peak.CHECK_A``,
   ``CHECK_B``), so that no wrong or missing operation passes; P1's own
   operands on the timed fma_dep workload; the measured peak (the dependent FMA and multiply
   chains, best of 5) and the suite's rates, each under 1.05 x 67 TFLOP/s
   or the probe fails. From here on every bound is printed at the data
   sheet's 67 TFLOP/s and at the measured peak.
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
   width (1,440,001 points, 66 layers, 9 altitudes, 30 angles), in both
   modes (the Planck source in-kernel; ``planck=False``, the source read
   from an (nL, nX) input, one direct launch): tau, Lu and Ld within 5e-6
   of peak.
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
3d. The Hartmann-Tran kernels against their plain versions on every pass
   of ``make_ht_fn`` (the bench's 20,000-line list, 30% live HT, 10 states)
   and ``make_od_ht_fn(differentiable=True)`` (2,000 lines, 40% live HT, 66
   layers) over 800-810 cm^-1 at 0.0025: K5 (``csrc/fused_ht.cu``) and the
   K1 ``sdvoigt``/``full`` passes within 2e-6 of the lattice's or OD's
   peak and of their own; K6 (``csrc/fused_ht.cu``), K4
   (``csrc/fused_xsect_jvp.cu``) and K3 for a T direction over all layers
   and a batch of 8 one-hot T directions, within ``HT_JVP_BOUND``,
   ``K4_BOUND`` and ``K3_BOUND`` of each tangent's own peak.
9. The HT lattice at full width (the JAX bench's metric 5: 400,001 points,
   10 states) with the launch counts reset before and read after (K5 must
   have run): plan-build seconds, CUDA-event milliseconds, states and
   window evaluations per second; a small lattice on the card and the CPU
   within 1e-5 of peak; ``xsect --profile ht`` through the CLI on the
   coarse-far route, AFIT files written and one read back.
9b. The layered HT OD at full width (metric 5b: 66 layers): milliseconds,
   window evaluations per second, the K5 and K1 launch counts.
9c. The HT Jacobian (``ht_jacobian_jvp_per_s``: 2,000 lines, 790-830
   cm^-1): d OD / d T[3], then all 66 one-hot T directions through ``vmap``
   of ``jvp`` with the counts reset before and read after (K3, K4 and K6
   must have run): wall seconds, directions per second, peak device
   memory; d OD / d T[3] on a small band on the card and on the CPU within
   1e-4 of its peak.
9d. The differentiable SD-Voigt OD at full width (the bench's 20,000-line
   list): a batch of 8 one-hot T directions, milliseconds and K4 launches.
10. Where the time of 9, 9b and 9c goes: CUDA-event milliseconds per kind
   of pass, each with its bound.
3e. K7, the unfused kernel (``csrc/fused_xsect.cu``), in each of its modes
   (full, asym, core, lorentz, doppler) against its plain version on
   ``make_od_plan``'s shared-block plan over the 700-740 cm^-1 sub-band at
   5e-4 (derived list, 66 layers): within 2e-6 of the OD peak and within
   its mode's own-output bound (K1's), bit-identical reruns; a packed plan
   against the shared one within 5e-7 of peak.
11. The prebuilt-plan route at full width: one ``make_od_plan``, then
   ``compute_od_layers(engine="pallas", plan=plan, continuum="mt_ckd")``
   for 4 members perturbed as ``run_tud`` perturbs them, with the launch
   counts reset before and read after (K7 must have run once a member, K1
   and K2 not); finite, >= 0; plan-build seconds and seconds a member;
   against ``make_od_fn(continuum="mt_ckd")`` on the base state within
   5e-6 of peak; where a member's time goes (line parameters, K7 with its
   bound, the continuum) and K7 against its plain version at full width;
   the route on a 5 cm^-1 band on the card against the CPU's float64 plain
   run, and make_od_fn on the card against the same run, each within 2e-6
   of peak.

Each kernel's bound is the larger of its bytes over 3.35 TB/s and its
operations over the card's rate for them (67 TFLOP/s FP32; K2's
exponentials also over the special-function units), with the evaluations
the kernel needs recounted on the host from the plans and the line
parameters (``window_counts``); the JSON line also carries it at the
measured FP32 peak (``bound_ms_measured_peak``), and for K1's production
modes, ``full`` and K2 in issue slots (``bound_ms_issue``: the SASS
lane-instructions that the needed work takes, the line shape's arithmetic
of each needed evaluation or K2's source and carry steps, counted from the
built library by ``radtxfr_tpu_torch/tools/sass.py`` without the kernel's
window tests, indexing or loop code, over 4 x 32 lanes x 132 SMs x 1.98
GHz, or the special-function ops or bytes where those take longer;
``bound_ms_issue_measured``: the instructions over phase 2b's measured
FMUL-chain rate).

It ends with one JSON line of kernel results and, last, the device line.
Any failed check raises; the script then exits non-zero without the last
line. There is no CPU fallback.
"""

import collections
import dataclasses
import functools
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
from radtxfr_tpu_torch.cli.main import (  # noqa: E402
    build_parser, ensemble_draws, ensemble_member, run_tud, run_xsect,
    write_xs)
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
from radtxfr_tpu_torch.core.constants import C1, C2  # noqa: E402
from radtxfr_tpu_torch.core.planck import planckian  # noqa: E402
from radtxfr_tpu_torch.kernels import fused_ht  # noqa: E402
from radtxfr_tpu_torch.kernels.ht_driver import (  # noqa: E402
    resolve_ht_columns)
from radtxfr_tpu_torch.products.od import (_coarse_upsample,  # noqa: E402
                                           _line_species_cols,
                                           compute_od_layers, ht_wing_bounds,
                                           layer_line_params, make_ht_fn,
                                           make_od_fn, make_od_ht_fn,
                                           make_od_plan, make_xsect_fn)
from radtxfr_tpu_torch.atmos.continuum import continuum_od  # noqa: E402
from radtxfr_tpu_torch.tools import fp32_peak, sass  # noqa: E402
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
# issue slots: one warp instruction per scheduler per clock, 4 schedulers
# an SM, counted per lane (an FFMA, FMUL, FADD, compare or select is one)
ISSUE_PER_S = 4 * 32 * 132 * 1.98e9
#: the FP32 issue rate the probe measures on this card (phase 2b), ops/s;
#: every bound is also stated against it
MEASURED = {}
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
# of csrc/fused_xsect.cu ("Bound."): the per-evaluation part of each mode,
# and per CPF point the branch it takes (sdvoigt, sdvoigt_core): Weideman
# inside the radius where that point lies in |x| + y < 15 (region_radii),
# the unguarded asymptotic form outside it. CPF3's sub-band is counted at
# Weideman's price (it costs a little more there: an undercount)
SD_BASE = 11 + 24 + 2        # PRE, the SD prelude, the tail
SD_SEL = 22                  # |Z1|, |Z2|, the CPF3 test and its selects
SD_WEI = 3 + 35 + 7 * N_WEI  # region test + Weideman (y elementwise)
SD_ASYM = 3 + 18             # region test + the unguarded asymptotic form
SD_GUARDED = 19              # the guarded asymptotic form
SD_OPS = {"sdvoigt_asym": SD_BASE + 2 * SD_GUARDED,
          "sdvoigt": SD_BASE + SD_SEL,
          "sdvoigt_core": SD_BASE + SD_SEL + 2 * (SD_GUARDED + 1)}
SIMPLE_OPS = {"lorentz": 18, "doppler": 20}
SPAN = 256            # points of a K1 CTA's slice (csrc: SPAN)
INTERP_OPS = 9        # a correction point's 4-node FMA interpolation + add

# the prebuilt-plan route (compute_od_layers(engine="pallas", plan=...)):
# K7's modes; a packed plan against the shared one
# (tests/test_pallas_xsect.py:397); the route at full width for 4 members
# against make_od_fn on the base state (README "<=2e-6 of peak" each from
# the float64 reference, so 5e-6 between the two: their Weideman terms,
# 24 against 16, and continua, pointwise against layer-hoisted, differ) and
# on a 5 cm^-1 band against the CPU's float64 plain run
K7_MODES = fused_xsect.UNFUSED_MODES
K7_PACKED_BOUND = 5e-7
OD_LAYERS_MEMBERS = 4
OD_LAYERS_SMALL = (718.0, 723.0, 0.0005)
ROUTE_VS_BUILDER = 5e-6
# the FP32 probe (P1/P2): each mix against its plain chains at both
# unrolled depths, 2 iterations each, with the check operands, within 4
# float32 ulps (an FFMA rounds once, its plain step in float64 rounded to
# float32), and the JSON entry's workload, fma_dep with P1's operands at
# depth 256 x 40 iterations on every SM's threads, for both versions
PROBE_CHECK = ((8, 2), (256, 2))      # (unrolled depth, iterations)
PROBE_ULPS = 4
PROBE_WORK_ITERS = 40

# the Hartmann-Tran path (the JAX bench's metrics 5, 5b and
# ht_jacobian_jvp_per_s, bench.py:543-585, 622-663, 697-726)
HT_BAND = (500.0, 1500.0, 0.0025)            # 400,001 points
HT_SUB = (800.0, 810.0, 0.0025)
HT_LINES = dict(n_lines=20_000, nu_min=480.0, nu_max=1520.0)
HT_JAC_LINES = dict(n_lines=2000, nu_min=780.0, nu_max=840.0, seed=77,
                    sd_zero_frac=0.4)
HT_JAC_BAND = (790.0, 830.0, 0.0025)
HT_JAC_LAYER = 3
HT_CLI = ("xsect --synthetic 2000 --numin 800 --numax 900 --dv 0.0025 "
          "--profile ht --wing-abs 60 --T 275 --T-max 320 --T-step 5")
# K5 against its plain version, of the pass's own peak: it follows the plain
# version's operations uncontracted (K1's SD-Voigt bound); K6 likewise, of
# each tangent's own peak: its dual numbers use torch's derivative formulas,
# each operation rounded on its own, so it rounds as the plain version even
# where the real-pair square root's tangent is ill-conditioned (Im(X + Y)
# crossing zero; there two float32 versions rounding in different orders
# part by 1e-3 of peak, tests/test_torch_ht_jacobian.py); K4 as K3
HT_OWN_BOUND = 2e-6
HT_JVP_BOUND = 2e-6
K4_BOUND = 2e-6
# lane-ops per evaluation, hand counts from the CUDA sources with the
# conventions above (a negation is free) and the branch each evaluation
# takes, by the radii of region_radii. K5 and K6 (csrc/fused_ht.cu
# "Bound."): each piece's (value ops; ops a dual number adds once per
# evaluation, the reciprocal's square and the square root's doubling; ops
# per direction by the Dual operators as written: + or - 1, dual * dual 3,
# float * dual 1, dual / dual 6, reciprocal 1, square root 4, the floor
# 0). PART4 (Gamma2 != 0) evaluates two w(Z), PART1 one (and its |Z1| >
# 4e3 form far out); K6 adds 5 per direction to accumulate
HT_PIECES = {"part4": (214, 3, 283), "part1": (76, 0, 108),
             "part1_big": (93, 0, 133),
             "w_wei": (41 + 7 * N_WEI, 2, 65 + 14 * N_WEI),
             "w_asym": (25, 1, 40)}
HT_ACC_DIR = 5
# K4 (csrc/fused_xsect_jvp.cu): the window, dnu, xi, S and the denominator
# 37, per CPF point a (K, Kx, Ky) after its 3-op region test (Weideman
# 49 + 15 n_wei or the asymptotic form's 38), 32 per direction
K4_BASE, K4_DIR = 37, 32
KG_WEI, KG_ASYM = 3 + 49 + 15 * N_WEI, 3 + 38


def ht_piece(name, nd):
    """K5's (nd = 0) or K6's lane-ops for one piece of an evaluation."""
    value, once, per_dir = HT_PIECES[name]
    return value + (once + nd * per_dir if nd else 0)


def cpf_pair_ops(n_win, n_in, w_in, w_out):
    """The two CPF points' w(Z) of ``n_win`` evaluations, of which
    ``n_in[i]`` lie in point i's Weideman region."""
    return sum(n * w_in + (n_win - n) * w_out for n in n_in)


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


SQRT_LN2 = float(np.sqrt(np.log(2.0)))


def cpf_radius(R, P):
    """The |Im(X + Y)| below which a CPF point Z = S -+ c, S = sqrt(X + Y)
    = us + i vs with Re(X + Y) = P and c real, lies in hum1_wei's Weideman
    region |x| + y = |vs| + us -+ c < 15, i.e. us + |vs| < R = 15 +- c:
    (us + |vs|)^2 = m + sqrt(m^2 - P^2) with m = |X + Y| grows with
    |Im(X + Y)| from |P|, and equals R^2 at m = (R^4 + P^2) / (2 R^2);
    0 where it never does."""
    R = np.asarray(R, dtype=np.float64)
    R2 = np.where(R > 0.0, R * R, 1.0)
    with np.errstate(over="ignore", invalid="ignore"):
        m = (R2 * R2 + P * P) / (2.0 * R2)
        q = np.sqrt(np.maximum(m * m - P * P, 0.0))
    return np.where((R > 0.0) & (np.abs(P) < R2), q, 0.0)


def region_radii(region, h, li, g):
    """(centre, radii, direct) for the evaluations of layer ``li`` and
    lines ``g``: the dnu (cm^-1) about which the profile's region tests are
    centred, for each test the radius (cm^-1) inside which it takes the
    Weideman branch (<= 0: nowhere), and a mask of the lines to count point
    by point instead (ht_point_counts), or None. 'voigt': |x| + y < 15
    about the shifted centre; 'sd': the two CPF points of the SD-Voigt
    profile (K1 sdvoigt*, K4), exactly (cpf_radius); 'ht4': those of a
    PART4 pcqsdhc evaluation (Gamma2 != 0) from its constants, by
    cpf_radius where c2t and csqrtY are real (eta real, Shift2 = 0), point
    by point where they are not; 'ht1': a PART1 evaluation's |x| + y < 15
    and the |Z1| <= 4e3 radius of its near form."""
    if region in ("voigt", "sd"):
        gd, g0, s0 = (h[k][li, g] for k in ("gamma_d", "gamma_0", "shift0"))
        if region == "voigt":
            return s0, [15.0 * gd / SQRT_LN2 - g0], None
        g2 = np.maximum(h["gamma_2"][li, g], 1e-4 * g0 + 1e-12)
        c = gd / (2.0 * SQRT_LN2 * g2)
        P = (g0 - 1.5 * g2) / g2 + c * c
        return s0, [g2 * cpf_radius(15.0 + c, P),
                    g2 * cpf_radius(15.0 - c, P)], None
    cte, k1, k2, c2r, c2i, cyr, cyi = (a[li, g] for a in h["ht"][:7])
    if region == "ht1":
        return k2, [15.0 / cte - k1,
                    np.sqrt(np.maximum((4e3 / cte) ** 2 - k1 * k1, 0.0))], None
    real = (c2i == 0.0) & (cyi == 0.0)
    P = k1 / np.where(real & (c2r != 0.0), c2r, 1.0) + cyr * cyr
    return k2, [np.where(real, np.abs(c2r) * cpf_radius(15.0 + s * cyr, P),
                         0.0) for s in (1.0, -1.0)], ~real


def ht_point_counts(h, li, g, c, lo, hi, dx, chunk=1 << 22):
    """The evaluations of PART4 lines ``g`` (layer ``li``; grid points
    lo..hi about the centre index c) whose two CPF points lie in their
    Weideman regions, tested as the kernel tests them (values, here in
    float64): Z = sqrt(X + Y) -+ csqrtY, |Im Z| + Re Z < 15. Only the points
    with |dnu - c0ti| < |c2t| ((15 + 3 |c|)^2 + |Y|) can be: there |S| <
    15 + 3 |c|, since Re Z >= -|c|."""
    cte, k1, k2, c2r, c2i, cyr, cyi = (a[li, g] for a in h["ht"][:7])
    c2t, cy = c2r + 1j * c2i, cyr + 1j * cyi
    r = np.abs(c2t) * ((15.0 + 3.0 * np.abs(cy)) ** 2
                       + 1.0 / (2.0 * cte * np.abs(c2t)) ** 2) / dx
    mid = c + k2 / dx
    a = np.maximum(np.floor(mid - r) + 1, lo)
    n = np.maximum(np.minimum(np.ceil(mid + r) - 1, hi) - a + 1,
                   0).astype(np.int64)
    counts = [0, 0]
    for j in np.split(np.arange(g.size), np.searchsorted(
            np.cumsum(n), np.arange(chunk, n.sum(), chunk))):
        idx = np.repeat(j, n[j])
        k = (np.repeat(a[j], n[j]) + np.arange(idx.size)
             - np.repeat(np.cumsum(n[j]) - n[j], n[j]))
        dnu = (k - c[idx]) * dx
        S = np.sqrt((k1[idx] + 1j * (k2[idx] - dnu)) / c2t[idx]
                    + (1.0 / (2.0 * cte[idx] * c2t[idx])) ** 2)
        for i, Z in enumerate((S - cy[idx], S + cy[idx])):
            counts[i] += int((np.abs(Z.imag) + Z.real < 15.0).sum())
    return counts


def window_counts(lay, dplan, prm, live=None, cap=True, region="voigt"):
    """The evaluations one pass needs, recounted on the host from its plan
    and the line parameters: the in-window (layer, line, point) triples, a
    tuple with the number of them inside each radius of ``region``
    (region_radii), and the number of distinct lines the pass reads.
    ``live`` (nLay, L) bool keeps only the pairs a tangent kernel evaluates
    (a non-zero tangent) or a part of the HT lines; ``cap`` False masks by
    the true window (the correction passes)."""
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
    f64 = lambda a: a.detach().cpu().numpy().astype(np.float64)  # noqa: E731
    if region.startswith("ht"):
        h = {"wing": f64(prm.wing), "ht": [f64(a) for a in prm.ht_consts]}
    else:
        h = {k: f64(getattr(prm, k)) for k in ("wing", "gamma_d", "gamma_0",
                                               "shift0", "gamma_2")}
    n_win, n_in = 0, None
    for li in lay.cpu().numpy():
        w = h["wing"][li, g]
        w = (np.minimum(w, wcap) if cap else w) / dplan.dx
        # integers k with c - w < k <= c + w inside the slot's tile
        lo = np.maximum(np.floor(c - w) + 1, lo_t)
        hi = np.minimum(np.floor(c + w), hi_t)
        keep = hi >= lo
        if live is not None:
            keep &= live[li, g]
        n_win += int((hi - lo + 1)[keep].sum())
        centre, radii, direct = region_radii(region, h, li, g)
        mid = c + centre / dplan.dx
        n_in = n_in or [0] * len(radii)
        for i, r in enumerate(radii):
            r = r / dplan.dx
            clo = np.maximum(np.floor(mid - r) + 1, lo)
            chi = np.minimum(np.ceil(mid + r) - 1, hi)
            kc = keep & (r > 0.0) & (chi >= clo)
            n_in[i] += int((chi - clo + 1)[kc].sum())
        if direct is not None and (keep & direct).any():
            sel = keep & direct
            for i, n in enumerate(ht_point_counts(h, li, g[sel], c[sel],
                                                  lo[sel], hi[sel],
                                                  dplan.dx)):
                n_in[i] += n
    return n_win, tuple(n_in or ()), int(np.unique(g).size)


def bound(ops, nbytes, sfu=0, fp32=FP32_OPS_PER_S):
    """(bound ms, what bounds it): the larger of the bytes over the memory
    rate and the operations over their peak rates (FP32 at ``fp32``, the
    data sheet's unless given)."""
    t_ops = max(ops / fp32, sfu / SFU_OPS_PER_S)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def bound_str(ops, nbytes, sfu=0):
    """The bound at the data sheet's FP32 peak and at the measured one
    (phase 2b), for the log lines."""
    ms, by = bound(ops, nbytes, sfu)
    return (f"{ms:.4f} ({by}; "
            f"{bound(ops, nbytes, sfu, MEASURED['fp32'])[0]:.4f} at the "
            "measured peak)")


@functools.lru_cache(maxsize=None)
def sass_listing(stem):
    """The parsed SASS of the built library of ``csrc/<stem>.cu``."""
    path = next(p for p in _build.build()
                if os.path.basename(p).rsplit("_", 1)[0] == f"lib{stem}")
    return sass.parse(sass.disassemble(path))


def csrc_text(stem):
    with open(os.path.join(_build.CSRC, f"{stem}.cu")) as f:
        return f.read()


@functools.lru_cache(maxsize=None)
def k1_issue(mode):
    """SASS lane-instructions one K1 evaluation in ``mode`` (asym, core, mix,
    full; the pass without SPLIT) needs: its line shape's arithmetic inside
    and outside |x| + y < 15 (``sass.k1_eval_instructions``)."""
    code = ("asym", "core", "mix", "full").index(mode)
    instrs = sass.kernel(sass_listing("fused_xsect"),
                         rf"fused_xsect_kernelILi{code}ELb0E")
    return sass.k1_eval_instructions(instrs, csrc_text("fused_xsect"), code,
                                     N_WEI)


def k1_issue_work(mode, lay, dplan, prm, counts=None):
    """The lane-instructions one K1 pass needs: each in-window evaluation at
    its region's SASS count."""
    n_win, (n_core,), _ = counts or window_counts(lay, dplan, prm)
    c = k1_issue(mode)
    return n_core * c["in"] + (n_win - n_core) * c["out"]


@functools.lru_cache(maxsize=None)
def k2_instructions(n_mu, n_a):
    """SASS lane-instructions per column and layer that K2's work needs,
    per mode (``sass.k2_instructions``)."""
    listing = sass_listing("fused_tud")
    out = {}
    for name, planck in (("tud", 1), ("tud_b", 0)):
        per = sass.k2_instructions(
            sass.kernel(listing, rf"fused_tud_kernelILb{planck}E"),
            csrc_text("fused_tud"), n_mu, n_a, bool(planck))
        out[name] = per["total"]
        print(f"[4 K2 {name}] SASS lane-instructions per column and layer: "
              + ", ".join(f"{k} {v:.2f}" for k, v in per.items()),
              flush=True)
    return out


def k1_bound_work(mode, lay, dplan, prm, counts=None):
    """(lane-ops, bytes) one K1 pass needs on these inputs: every needed
    evaluation at its region's hand count; each parameter of the lines it
    reads, each plan slot and each output element once. ``counts``: the
    pass's ``window_counts``, when already taken."""
    n_win, (n_core,), n_lines = counts or window_counts(lay, dplan, prm)
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
    n_win, n_in, n_lines = window_counts(lay, dplan, prm, cap=not corr,
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
                    + n_nodes * (SD_OPS["sdvoigt_asym"] if sd
                                 else K1_OPS["asym"][0]))
    if kind in SIMPLE_OPS:
        ops += n_win * SIMPLE_OPS[kind]
    elif kind in SD_OPS:
        ops += n_win * SD_OPS[kind]
        if kind != "sdvoigt_asym":
            ops += cpf_pair_ops(n_win, n_in, SD_WEI, SD_ASYM)
    else:
        ops_in, ops_out = K1_OPS[kind]
        ops += n_in[0] * ops_in + (n_win - n_in[0]) * ops_out
    nbytes = (4 * (6 if sd else 5) * nl * n_lines
              + 16 * dplan.k_line.numel() + 4 * nl * dplan.n_out)
    return ops, nbytes


def live_pairs(prm, tangents):
    """(nLay, L) bool: the pairs where any of the (nd, nLay, L) tangents is
    non-zero."""
    live = np.zeros(tuple(prm.strength.shape), dtype=bool)
    for t in tangents:
        live |= (t != 0).any(dim=0).cpu().numpy()
    return live


def k3_bound_work(lay, dplan, prm, tangents):
    """(lane-ops, bytes) of one K3 launch set for the (nd, nLay, L)
    tangents: the live evaluations only, as the kernel skips the rest."""
    nd = tangents[0].shape[0]
    n_win, (n_core,), n_lines = window_counts(lay, dplan, prm,
                                              live_pairs(prm, tangents))
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
        counts = window_counts(lay, dplan, prm)
        add_stats(stats, mode, err, k_ms, p_ms,
                  *k1_bound_work(mode, lay, dplan, prm, counts),
                  instr=k1_issue_work(mode, lay, dplan, prm, counts))
    for mode in PRODUCTION_MODES:
        c = k1_issue(mode)
        print(f"[3 K1 {mode}] SASS lane-instructions an evaluation needs: "
              f"{c['in']:.2f} inside |x| + y < 15, {c['out']:.2f} outside; "
              f"Weideman {c['weideman_term']:.2f} a term", flush=True)
    check(set(stats) == set(PRODUCTION_MODES),
          f"K1 sub-band exercised modes {sorted(stats)}")
    return finish_stats(stats)


def add_stats(stats, name, err, k_ms, p_ms, ops, nbytes, sfu=0,
              instr=None):
    """Accumulate one pass into ``stats[name]``; ``instr``: the issue slots
    (SASS lane-instructions) its needed work takes, where counted."""
    s = stats.setdefault(name, {"max_abs_err": 0.0, "ms": 0.0,
                                "plain_ms": 0.0, "ops": 0, "bytes": 0,
                                "sfu": 0, "instr": None})
    s["max_abs_err"] = max(s["max_abs_err"], err)
    s["ms"] += k_ms
    s["plain_ms"] += p_ms
    s["ops"] += ops
    s["bytes"] += nbytes
    s["sfu"] += sfu
    if instr is not None:
        s["instr"] = (s["instr"] or 0) + instr


def issue_bounds(instr, nbytes=0, sfu=0):
    """The issue-slot bound of work that needs ``instr`` lane-instructions,
    ``nbytes`` bytes and ``sfu`` special-function ops: the larger of the
    instructions at the card's issue rate (132 SMs x 4 schedulers x 32
    lanes x 1.98 GHz), or at the FMUL-chain rate phase 2b measures, the
    special-function ops at their rate and the bytes at the memory rate."""
    floor = max(sfu / SFU_OPS_PER_S, nbytes / HBM_BYTES_PER_S)
    return {"bound_ms_issue": max(instr / ISSUE_PER_S, floor) * 1e3,
            "bound_ms_issue_measured": max(instr / MEASURED["issue"],
                                           floor) * 1e3}


def finish_stats(stats):
    """The JSON fields of each kernel: errors, times, and the bound of the
    work those times cover (and in issue slots, where counted)."""
    out = {}
    for name, s in stats.items():
        b_ms, b_by = bound(s["ops"], s["bytes"], s["sfu"])
        out[name] = {"max_abs_err": s["max_abs_err"], "ms": s["ms"],
                     "plain_ms": s["plain_ms"], "bound_ms": b_ms,
                     "bound_by": b_by, "library_ms": None,
                     "bound_ms_measured_peak": bound(
                         s["ops"], s["bytes"], s["sfu"],
                         MEASURED["fp32"])[0]}
        if s["instr"] is not None:
            out[name].update(issue_bounds(s["instr"], s["bytes"],
                                          s["sfu"]))
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
        counts = window_counts(lay, dplan, prm)
        add_stats(stats, "full", err, k_ms, p_ms,
                  *k1_bound_work("full", lay, dplan, prm, counts),
                  instr=k1_issue_work("full", lay, dplan, prm, counts))
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
    # planck=False: the Planck source read from memory, (nL, nX)
    nu = x * 100.0
    B = (((nu * nu * nu) * (C1 * 1e4))[None, :] / torch.expm1(
        (nu * C2)[None, :] * inv_t[:, None])).contiguous()
    n_x, n_l, n_zs, n_mu, n_a = X.size, base.n_layers, len(ALTITUDES), 1, 30
    instr = k2_instructions(n_mu, n_a)
    out = {}
    for name, kern, plain, planck in (
            ("tud", lambda: fused_tud.tud_compose(*args),
             lambda: fused_tud.tud_compose_plain(*args), True),
            ("tud_b", lambda: fused_tud.tud_compose(*args, B=B),
             lambda: fused_tud.tud_compose_plain(*args, B=B), False)):
        reset_launches()
        kern()
        out[name] = {"launches": read_launches()[name]}
        k_ms, got = cuda_ms(kern, 5)
        again = kern()
        check(all(torch.equal(a, b) for a, b in zip(got, again)),
              f"K2 {name}: two launches on the same inputs differ")
        p_ms, want = cuda_ms(plain, 1)
        err_max = 0.0
        for prod, g, r in zip(("tau", "Lu", "Ld"), got, want):
            err = (g - r).abs().max().item()
            rel = err / r.abs().max().item()
            err_max = max(err_max, err)
            print(f"[4 K2 {name} {prod}] shape {tuple(g.shape)}: "
                  f"max|kernel-plain| {err:.3e} = {rel:.3e} of peak",
                  flush=True)
            check(rel <= K2_BOUND, f"K2 {name} {prod}: {rel:.3e} of peak > "
                  f"{K2_BOUND}")
        print(f"[4 K2 {name}] {n_x} points x 66 layers, 9 altitudes, 30 "
              f"angles, Planck source {'in-kernel' if planck else 'read'}: "
              f"kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms [{card}]",
              flush=True)
        # per column and layer: one exp2 per secant and one per
        # downwelling angle, the Planck source's expm1 (an exp2) and divide
        # (a reciprocal) once, each one special-function op; the expf of
        # each snapshot. FP32 operations by hand: expm1f ~20 and the divide
        # ~8, each exp2's argument 1, each carry update 2 (FADD, FFMA)
        sfu = n_x * (n_l * (n_mu + n_a + (2 if planck else 0))
                     + n_zs * n_mu)
        ops = n_x * n_l * ((28 if planck else 0) + (n_mu + n_a) * 3)
        nbytes = (4 * n_l * n_x * (1 if planck else 2)
                  + (4 * (n_x + n_l) if planck else 0)
                  + 4 * n_x * (2 * n_zs * n_mu + 1))
        stats = {}
        add_stats(stats, name, err_max, k_ms, p_ms, ops, nbytes, sfu,
                  instr=n_x * n_l * instr[name])
        out[name].update(finish_stats(stats)[name])
        print(f"[4 K2 {name}] bound {out[name]['bound_ms']:.4f} ms "
              f"({out[name]['bound_by']}; "
              f"{out[name]['bound_ms_measured_peak']:.4f} ms at the measured"
              f" peak: {sfu:.4g} special-function ops at "
              f"{SFU_OPS_PER_S:.4g}/s, {ops:.4g} lane-ops at "
              f"{FP32_OPS_PER_S:.4g}/s, {nbytes:.4g} B at "
              f"{HBM_BYTES_PER_S:.4g} B/s); in issue slots "
              f"{instr[name]:.2f} a column and layer (SASS): "
              f"{out[name]['bound_ms_issue']:.4f} ms, "
              f"{out[name]['bound_ms_issue_measured']:.4f} ms at the "
              f"measured FMUL rate [{card}]", flush=True)
    return out


def reset_launches():
    fused_xsect.LAUNCHES.clear()
    for k in fused_tud.LAUNCHES:
        fused_tud.LAUNCHES[k] = 0


def read_launches():
    """The launches since the last reset, per kernel (0 for any not run)."""
    return collections.Counter(fused_xsect.LAUNCHES, **fused_tud.LAUNCHES)


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
        f"{m} {bound_str(*w)}" for m, w in work.items())
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
    issue = {m: 0.0 for m in PRODUCTION_MODES}
    prm, _ = od_fn.line_params(T, p, pl, vmr)
    for lay, dplan, mode in od_fn.calls:
        slot_points[mode] += (lay.numel() * int(dplan.counts.sum())
                              * dplan.block * dplan.tile)
        counts = window_counts(lay, dplan, prm)
        n_win, (n_core,), _ = counts
        ops, nbytes = k1_bound_work(mode, lay, dplan, prm, counts)
        work[mode] = [work[mode][0] + ops, work[mode][1] + nbytes]
        issue[mode] += k1_issue_work(mode, lay, dplan, prm, counts)
        print(f"[6 evaluations] {mode} pass, {lay.numel()} layers: "
              f"in-window {n_win:.4g}, in-core {n_core:.4g}", flush=True)
    print(f"[6 breakdown] full-width plan build {build_s:.3f} s; one member "
          f"(std atmosphere), ms per stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; plan (layer x slot x point) counts per mode {slot_points} "
          f"[{card}]", flush=True)
    print("[6 bounds] per member, K1 bound ms: " + ", ".join(
        f"{m} {bound_str(*w)}" for m, w in work.items())
        + f" [{card}]", flush=True)
    print("[6 bounds] per member, K1 bound ms in issue slots (SASS "
          "lane-instructions the in-window evaluations need): " + ", ".join(
              f"{m} {b['bound_ms_issue']:.4f} "
              f"({b['bound_ms_issue_measured']:.4f} at the measured FMUL "
              f"rate)" for m, b in ((m, issue_bounds(i, work[m][1]))
                                    for m, i in issue.items()))
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
    full_issue = 0.0
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
        full_issue += k1_issue_work("full", lay, dplan, prm)
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
          + ", ".join(f"{k} {bound_str(*w)}"
                      for k, w in work.items())
          + "; K1 full in issue slots {bound_ms_issue:.4f} "
          "({bound_ms_issue_measured:.4f} at the measured FMUL rate)".format(
              **issue_bounds(full_issue, work["full"][1]))
          + f" [{card}]", flush=True)


def ht_extras(n, seed, frac):
    """The JAX bench's HT columns (bench.py:636-640): ``frac`` of the lines
    with live nuVC and eta (the HT kernel), the rest resolving to pcqsdhc's
    SD-Voigt and Voigt degenerations."""
    rng = np.random.default_rng(seed)
    rows = rng.random(n) < frac
    return {"nu_HT_air": rng.uniform(0.01, 0.05, n) * rows,
            "kappa_HT_air": rng.uniform(0.0, 1.0, n) * rows,
            "eta_HT_air": rng.uniform(0.1, 0.3, n) * rows}


def ht_lattice_case(dev):
    """Metric 5's lines (bench.py:557's list with seed 0) and HT columns."""
    store = synthetic_lines(HT_LINES["n_lines"], nu_min=HT_LINES["nu_min"],
                            nu_max=HT_LINES["nu_max"], seed=0, device=dev)
    return store, ht_extras(len(store), 3, 0.3)


def ht_layered_case(dev):
    """Metric 5b's lines (seed 2, 40% SD_air = 0) and HT columns."""
    store = synthetic_lines(HT_LINES["n_lines"], nu_min=HT_LINES["nu_min"],
                            nu_max=HT_LINES["nu_max"], seed=2,
                            sd_zero_frac=0.4, device=dev)
    return store, ht_extras(len(store), 5, 0.3)


def ht_jac_case(dev):
    """ht_jacobian_jvp_per_s's 2,000 lines and HT columns (40% live)."""
    spec = dict(HT_JAC_LINES)
    store = synthetic_lines(spec.pop("n_lines"), device=dev, **spec)
    return store, ht_extras(len(store), 5, 0.4)


def ht_window_evals(store, extras, diluent, X, T, p_atm):
    """Nominal hapi-window evaluations as the JAX bench counts them
    (bench.py:649-660): the grid points inside each (state, line) window
    of ht_wing_bounds."""
    resolved = resolve_ht_columns(store, extras, diluent)
    W = ht_wing_bounds(resolved, store.host_view(),
                       IsoTables.load(device="cpu", dtype=torch.float64),
                       np.asarray(T, dtype=np.float64),
                       np.asarray(p_atm, dtype=np.float64))
    nu0 = np.broadcast_to(store.host["nu0"], W.shape)
    lo = np.searchsorted(X, (nu0 - W).ravel(), side="right")
    hi = np.searchsorted(X, (nu0 + W).ravel(), side="right")
    return int((hi - lo).sum())


def ht_bound_work(lay, dplan, prm, tangents=None):
    """(lane-ops, bytes) of one K5 pass, or of one K6 launch set for the
    (nd, nLay, L) ``tangents`` (the live evaluations only): PART4 pairs
    (Gamma2 != 0) with each CPF point's w(Z) by its own region, PART1 pairs
    by |x| + y < 15 and the |Z1| <= 4e3 radius."""
    part4 = ((prm.ht_consts[3] != 0) | (prm.ht_consts[4] != 0)).cpu().numpy()
    nd = 0 if tangents is None else tangents[0].shape[0]
    live = np.ones_like(part4) if tangents is None else live_pairs(prm,
                                                                   tangents)
    n_win, n_in, n_lines = window_counts(lay, dplan, prm, part4 & live,
                                         region="ht4")
    ops = (n_win * (ht_piece("part4", nd) + nd * HT_ACC_DIR)
           + cpf_pair_ops(n_win, n_in, ht_piece("w_wei", nd),
                          ht_piece("w_asym", nd)))
    n_win, (n_w, n_near), _ = window_counts(lay, dplan, prm, ~part4 & live,
                                            region="ht1")
    ops += (n_win * (ht_piece("part1", nd) + nd * HT_ACC_DIR)
            + cpf_pair_ops(n_win, (n_w,), ht_piece("w_wei", nd),
                           ht_piece("w_asym", nd))
            + (n_win - n_near) * (ht_piece("part1_big", nd)
                                  - ht_piece("part1", nd)))
    nl = lay.numel()
    nbytes = (4 * (13 + 12 * nd) * nl * n_lines + 16 * dplan.k_line.numel()
              + 4 * max(nd, 1) * nl * dplan.n_out)
    return ops, nbytes


def k4_bound_work(lay, dplan, prm, tangents):
    """(lane-ops, bytes) of one K4 launch set for the (nd, nLay, L)
    tangents: the live evaluations, each CPF point's (K, Kx, Ky) by its own
    region."""
    nd = tangents[0].shape[0]
    n_win, n_in, n_lines = window_counts(lay, dplan, prm,
                                         live_pairs(prm, tangents),
                                         region="sd")
    nl = lay.numel()
    nbytes = (4 * (6 + 5 * nd) * nl * n_lines + 16 * dplan.k_line.numel()
              + 4 * nd * nl * dplan.n_out)
    return (n_win * (K4_BASE + K4_DIR * nd)
            + cpf_pair_ops(n_win, n_in, KG_WEI, KG_ASYM)), nbytes


def ht_od_tangents(fn, base, V):
    """The HT OD's line-parameter tangents of the T directions ``V`` (nd,
    nLay): (shift0, strength, gamma_d, gamma_0, gamma_2, the 11 HT
    constants), each (nd, nLay, L) and contiguous."""
    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr

    def prm_of(T_):
        q = fn.line_params(T_, p, pl, vmr)
        return (q.shift0, q.strength, q.gamma_d, q.gamma_0, q.gamma_2,
                *q.ht_consts)

    tans = torch.func.vmap(lambda v: torch.func.jvp(prm_of, (T,), (v,))[1])(V)
    return [t.contiguous() for t in tans]


def ht_primal(call, prm, plain=False):
    """One pass of an HT builder through its kernel or its plain version."""
    lay, dplan, mode = call
    if mode == "ht":
        f = fused_ht.xsect_ht_plain if plain else fused_ht.xsect_ht
        return f(dplan, lay, prm.strength, prm.wing, prm.ht_consts, N_WEI)
    f = fused_xsect.xsect_fused_plain if plain else fused_xsect.xsect_fused
    return f(dplan, lay, prm.shift0, prm.strength, prm.gamma_d, prm.gamma_0,
             prm.wing, None, mode, N_WEI,
             gamma_2=prm.gamma_2 if mode == "sdvoigt" else None)


def ht_tangent(call, prm, tans, plain=False):
    """The tangent of one pass of the differentiable HT builder: K6 (ht),
    K4 (sdvoigt) or K3 (full), or its plain version; ``tans`` as
    :func:`ht_od_tangents` gives them."""
    lay, dplan, mode = call
    s0_t, s_t, gd_t, g0_t, g2_t, *c_t = tans
    if mode == "ht":
        f = fused_ht.xsect_ht_jvp_plain if plain else fused_ht.xsect_ht_jvp
        return f(dplan, lay, prm.strength, prm.wing, prm.ht_consts, s_t, c_t,
                 N_WEI)
    args = (dplan, lay, prm.shift0, prm.strength, prm.gamma_d, prm.gamma_0)
    if mode == "sdvoigt":
        f = (fused_xsect.xsect_sdvoigt_jvp_plain if plain
             else fused_xsect.xsect_sdvoigt_jvp)
        return f(*args, prm.gamma_2, prm.wing, s0_t, s_t, gd_t, g0_t, g2_t,
                 N_WEI)
    f = (fused_xsect.xsect_fused_jvp_plain if plain
         else fused_xsect.xsect_fused_jvp)
    return f(*args, prm.wing, s0_t, s_t, gd_t, g0_t, N_WEI)


HT_TANGENT_NAME = {"ht": "K6", "sdvoigt": "K4", "full": "K3"}


def phase_ht_sub(dev, card):
    """3d: every pass of make_ht_fn and make_od_ht_fn(differentiable=True)
    over 800-810 cm^-1 against its plain version (K5, K1 sdvoigt and full),
    and each tangent pass of the latter (K6, K4, K3) for a T direction over
    all layers and 8 one-hot T directions; returns the JSON fields of K5,
    K6 and K4 (times and bound from the 8-direction batch)."""
    iso = IsoTables.load(device=dev)
    X = arange_drift_free(*HT_SUB)
    T, p = xs_states(dev)
    store, extras = ht_lattice_case(dev)
    lat = make_ht_fn(store, iso, X, XS_T, np.ones_like(XS_T), extras=extras)
    jstore, jextras = ht_jac_case(dev)
    base = std_atmosphere(device=dev)
    odf = make_od_ht_fn(jstore, iso, X, base, extras=jextras,
                        differentiable=True)
    check({c[2] for c in odf.calls} == {"ht", "sdvoigt", "full"}
          and "ht" in {c[2] for c in lat.calls}, "3d: the HT builders did "
          "not plan all three routes")
    prm_l = lat.line_params(T, p)
    prm_o = odf.line_params(base.T, base.p, base.pl, base.vmr)
    n_lay = base.n_layers
    sets = {"T linspace(0.5, 1.5)": ht_od_tangents(
                odf, base, torch.linspace(0.5, 1.5, n_lay, device=dev)[None]),
            "8 one-hot T (layers 24-31)": ht_od_tangents(odf, base,
                                                         one_hot_batch(dev))}
    runs = [("lattice", lat, prm_l, c, None, None) for c in lat.calls]
    runs += [("layered OD", odf, prm_o, c, None, None) for c in odf.calls]
    runs += [("layered OD", odf, prm_o, c, name, tans) for c in odf.calls
             for name, tans in sets.items()]
    timed = time_kernels(
        (f"3d {c[2]}", (lambda c=c, prm=prm, tans=tans:
                        ht_primal(c, prm) if tans is None
                        else ht_tangent(c, prm, tans)))
        for _, _, prm, c, _, tans in runs)
    peaks = {"lattice": lat.line_sum(prm_l).abs().max().item(),
             "layered OD": odf.line_sum(prm_o).abs().max().item()}
    stats = {}
    for (label, fn, prm, call, name, tans), (k_ms, k_out) in zip(runs, timed):
        lay, dplan, mode = call
        if tans is None:
            p_ms, p_out = cuda_ms(lambda: ht_primal(call, prm, plain=True), 1)
            kname = "K5" if mode == "ht" else f"K1 {mode}"
            bound_own = HT_OWN_BOUND if mode == "ht" else XS_OWN_BOUND[mode]
            touched = True
        else:
            p_ms, p_out = cuda_ms(lambda: ht_tangent(call, prm, tans,
                                                     plain=True), 1)
            kname = f"{HT_TANGENT_NAME[mode]} {name}"
            bound_own = {"ht": HT_JVP_BOUND, "sdvoigt": K4_BOUND,
                         "full": K3_BOUND}[mode]
            touched = any(bool((t != 0).any(dim=0).any(dim=1)[lay.long()]
                               .any()) for t in tans)
        err = (k_out - p_out).abs().max().item()
        own = p_out.abs().max().item()
        check(bool(torch.isfinite(k_out).all()) and (own > 0.0) == touched,
              f"3d {label} {kname}: non-finite, or zero where touched")
        rel = err / own if touched else err
        print(f"[3d {label}] {kname} layers {lay.numel()} tile {dplan.tile} "
              f"block {dplan.block} tiles {dplan.n_tiles}: max|kernel-plain| "
              f"{err:.3e} = {rel:.3e} of its own peak {own:.4e}"
              + (f" = {err / peaks[label]:.3e} of the {label}'s peak"
                 if tans is None else "")
              + f"; kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms [{card}]",
              flush=True)
        check(rel <= bound_own if touched else err == 0.0,
              f"3d {label} {kname}: {rel:.3e} of its own peak > {bound_own}")
        if tans is None:
            check(err <= XS_BOUND * peaks[label], f"3d {label} {kname}: "
                  f"{err / peaks[label]:.3e} of the {label}'s peak > "
                  f"{XS_BOUND}")
            if mode == "ht":
                add_stats(stats, "ht", err, k_ms, p_ms,
                          *ht_bound_work(lay, dplan, prm))
        elif name.startswith("8") and mode == "ht":
            add_stats(stats, "ht_jvp", err, k_ms, p_ms,
                      *ht_bound_work(lay, dplan, prm, [tans[1], *tans[5:]]))
        elif name.startswith("8") and mode == "sdvoigt":
            add_stats(stats, "sdvoigt_jvp", err, k_ms, p_ms,
                      *k4_bound_work(lay, dplan, prm, tans[:5]))
    return finish_stats(stats)


def phase_ht_lattice(dev, card):
    """9: the HT lattice at full width, the JAX bench's metric 5
    (bench.py:622-663), with the launch counts reset before and read after
    (K5 must have run); a small lattice on the card and on the CPU; then
    ``xsect --profile ht`` through the CLI on the coarse-far route."""
    store, extras = ht_lattice_case(dev)
    X = arange_drift_free(*HT_BAND)
    T, p = xs_states(dev)
    t0 = time.perf_counter()
    fn = make_ht_fn(store, IsoTables.load(device=dev), X, XS_T,
                    np.ones_like(XS_T), extras=extras)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    reset_launches()
    out = fn(T, p)
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches["ht"] > 0, "kernel ht was not launched by the HT "
          "lattice")
    check(out.shape == (XS_T.size, X.size) and bool(torch.isfinite(out).all())
          and out.max().item() > 0.0, "the HT lattice is not finite and "
          "positive somewhere")
    ms, _ = cuda_ms(lambda: fn(T, p), 3)
    evals = ht_window_evals(store, extras, {"air": 1.0}, X, XS_T,
                            np.ones_like(XS_T))
    print(f"[9 ht lattice] 20000 lines (seed 0, 30% live HT), {XS_T.size} "
          f"states x {X.size} points: launches "
          f"{ {k: v for k, v in launches.items() if v} }; plan build "
          f"{build_s:.3f} s, lattice {ms:.3f} ms (CUDA events, warm), "
          f"{XS_T.size / ms * 1e3:.3f} states/s, {evals:.4e} window "
          f"evaluations = {evals / ms * 1e3:.4e} "
          f"ht_window_evals_per_s [{card}]", flush=True)
    del out

    # a small lattice, card against the CPU's plain versions
    small = synthetic_lines(300, nu_min=790.0, nu_max=820.0, seed=4,
                            sd_zero_frac=0.3, device="cpu")
    sx = ht_extras(len(small), 6, 0.4)
    Xs = arange_drift_free(800.0, 810.0, 0.0025)
    res = {}
    for d in (dev, "cpu"):
        s_d = type(small).from_numpy(**small.host, device=d)
        f = make_ht_fn(s_d, IsoTables.load(device=d), Xs, XS_T,
                       np.ones_like(XS_T), extras=sx)
        Td = torch.as_tensor(XS_T, dtype=torch.float32, device=d)
        res[d] = f(Td, torch.ones_like(Td)).cpu().numpy()
    rel = np.abs(res[dev] - res["cpu"]).max() / np.abs(res["cpu"]).max()
    print(f"[9 slice] 300 lines, 800-810 cm^-1, 10 states: card vs CPU "
          f"plain {rel:.3e} of peak", flush=True)
    check(rel <= XS_SLICE_BOUND, f"HT slice: {rel:.3e} > {XS_SLICE_BOUND}")

    # the CLI: no HT columns, so the SD-Voigt route, coarse-far
    args = xs_args(HT_CLI)
    timings = {}
    reset_launches()
    xs = run_xsect(args, dev, timings)
    cli = read_launches()
    check(cli["sdvoigt_asym"] > 0 and cli["corr:64:sdvoigt"] > 0,
          f"xsect --profile ht did not take the coarse-far route: {cli}")
    check(np.isfinite(xs["K"]).all() and xs["K"].max() > 0.0,
          "xsect --profile ht: lattice not finite and positive")
    with tempfile.TemporaryDirectory() as tmp:
        paths = write_xs(os.path.join(tmp, "xs"), xs, "radtxfr_tpu synthetic")
        rX, rY, meta = xs_read(paths[-1])
        check(len(paths) == XS_T.size and rX.size == xs["X"].size
              and np.array_equal(rY, xs["K"][-1].astype(np.float64))
              and meta["T"] == XS_T[-1], "AFIT file read back differs")
    print(f"[9 cli] {HT_CLI}: launches "
          f"{ {k: v for k, v in cli.items() if v} }; plan build "
          f"{timings['build_s']:.3f} s, lattice {timings['run_s']:.3f} s "
          f"wall; AFIT files written and read back [{card}]", flush=True)
    return launches


def phase_ht_layered(dev, card):
    """9b: the layered HT OD at full width, the JAX bench's metric 5b
    (bench.py:543-585: 66 US-1976 layers, 30% live HT)."""
    store, extras = ht_layered_case(dev)
    X = arange_drift_free(*HT_BAND)
    base = std_atmosphere(device=dev)
    t0 = time.perf_counter()
    fn = make_od_ht_fn(store, IsoTables.load(device=dev), X, base,
                       extras=extras)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    args = (base.T, base.p, base.pl, base.vmr)
    reset_launches()
    od = fn(*args)
    torch.cuda.synchronize()
    launches = read_launches()
    for k in ("ht", "sdvoigt", "full"):
        check(launches[k] > 0, f"kernel {k} was not launched by the layered "
              "HT OD")
    # non-negative but for float32 rounding (the SD-Voigt and HT far wings
    # are differences w(Z1) - w(Z2) of near-equal values)
    peak, low = od.max().item(), od.min().item()
    n_bad, n_neg = int((~torch.isfinite(od)).sum()), int((od < 0).sum())
    print(f"[9b ht layered] OD peak {peak:.4e}, min {low:.4e} "
          f"({n_neg} negative values), {n_bad} non-finite", flush=True)
    if n_bad or low < -XS_BOUND * peak:
        prm = fn.line_params(*args)
        for call in fn.calls:
            o = fn.run_call(call, prm)
            print(f"[9b pass] {call[2]} layers {call[0].tolist()}: "
                  f"{int((~torch.isfinite(o)).sum())} non-finite, min "
                  f"{o.min().item():.4e}, max {o.max().item():.4e}",
                  flush=True)
    check(n_bad == 0 and peak > 0.0 and low >= -XS_BOUND * peak,
          "layered HT OD not finite, or negative beyond rounding")
    del od
    ms, _ = cuda_ms(lambda: fn(*args), 2)
    evals = ht_window_evals(store, extras, {"air": 1.0, "self": 1.0}, X,
                            base.T.cpu().numpy(),
                            base.p.cpu().numpy() / 101325.0)
    print(f"[9b ht layered] 20000 lines (seed 2, 40% SD_air = 0, 30% live "
          f"HT), 66 layers x {X.size} points: launches K5 {launches['ht']}, "
          f"K1 sdvoigt {launches['sdvoigt']}, K1 full {launches['full']}; "
          f"plan build {build_s:.3f} s, OD {ms:.3f} ms (CUDA events, warm), "
          f"{evals:.4e} window evaluations = {evals / ms * 1e3:.4e} "
          f"ht_layered_od_window_evals_per_s [{card}]", flush=True)
    return launches


def phase_ht_jacobian(dev, card):
    """9c: the HT Jacobian, the JAX bench's ht_jacobian_jvp_per_s
    (bench.py:697-726): d OD / d T[3], then all 66 one-hot T directions
    through ``vmap`` of ``jvp``, with the launch counts reset before and read
    after (K3, K4 and K6 must have run); then a small band card vs CPU."""
    store, extras = ht_jac_case(dev)
    X = arange_drift_free(*HT_JAC_BAND)
    base = std_atmosphere(device=dev)
    fn = make_od_ht_fn(store, IsoTables.load(device=dev), X, base,
                       extras=extras, differentiable=True)
    p, pl, vmr = base.p, base.pl, base.vmr
    e3 = torch.zeros_like(base.T)
    e3[HT_JAC_LAYER] = 1.0
    jvp3 = lambda: torch.func.jvp(  # noqa: E731
        lambda T_: fn(T_, p, pl, vmr), (base.T,), (e3,))[1]
    # single readings of this path swing about 2x between calls (its plain
    # HT-parameter tangents are hundreds of small launches from the host):
    # five timed calls and three runs of the 66 directions, with their range
    ms3s = []
    for _ in range(5):
        ms, d3 = cuda_ms(jvp3, 1)
        ms3s.append(ms)
    check(bool(torch.isfinite(d3).all()) and d3.abs().max().item() > 0.0,
          "d OD / d T[3] not finite or zero")
    V = torch.eye(base.n_layers, device=dev)
    walls = []
    for rep in range(3):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        t0 = time.perf_counter()
        _, J = torch.func.vmap(lambda v: torch.func.jvp(
            lambda T_: fn(T_, p, pl, vmr), (base.T,), (v,)),
            out_dims=(None, 0))(V)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        if rep == 0:
            launches = read_launches()
            peak_gib = torch.cuda.max_memory_allocated() / 2**30
    for k in ("jvp", "sdvoigt_jvp", "ht_jvp"):
        check(launches[k] > 0, f"kernel {k} was not launched by the HT "
              "Jacobian")
    check(J.shape == (base.n_layers, base.n_layers, X.size)
          and bool(torch.isfinite(J).all()), "HT Jacobian shape or values")
    rel3 = ((J[HT_JAC_LAYER] - d3).abs().max() / d3.abs().max()).item()
    check(rel3 <= 1e-6, f"the batched d/dT[3] differs from the single jvp: "
          f"{rel3:.3e}")
    ms3, wall = float(np.median(ms3s)), float(np.median(walls))
    print(f"[9c ht jacobian] 2000 lines (40% live HT), 66 layers x {X.size} "
          f"points: d OD/d T[3] median {ms3:.3f} ms of 5 calls (range "
          f"{min(ms3s):.3f}-{max(ms3s):.3f}; CUDA events, warm; "
          f"{1e3 / ms3:.3f} ht_jacobian_jvp_per_s); 66 one-hot directions "
          f"median {wall:.3f} s wall of 3 runs (range {min(walls):.3f}-"
          f"{max(walls):.3f}; {base.n_layers / wall:.3f} directions/s), "
          f"peak device memory {peak_gib:.3f} GiB; launches (first run) "
          f"{ {k: v for k, v in launches.items() if v} } [{card}]",
          flush=True)
    del J

    # a small band, card against the CPU's plain versions
    small = synthetic_lines(200, nu_min=795.0, nu_max=815.0, seed=77,
                            sd_zero_frac=0.4, device="cpu")
    sx = ht_extras(len(small), 5, 0.4)
    res = {}
    for d in (dev, "cpu"):
        s_d = type(small).from_numpy(**small.host, device=d)
        b = std_atmosphere(device=d)
        f = make_od_ht_fn(s_d, IsoTables.load(device=d),
                          arange_drift_free(800.0, 810.0, 0.005), b,
                          extras=sx, differentiable=True)
        e = torch.zeros_like(b.T)
        e[HT_JAC_LAYER] = 1.0
        res[d] = torch.func.jvp(lambda T_: f(T_, b.p, b.pl, b.vmr), (b.T,),
                                (e,))[1].cpu().numpy()
    rel = np.abs(res[dev] - res["cpu"]).max() / np.abs(res["cpu"]).max()
    print(f"[9c slice] 200 lines, 800-810 cm^-1 at 5e-3, d OD/d T[3]: card "
          f"vs CPU plain {rel:.3e} of peak", flush=True)
    check(rel <= JAC_SLICE_BOUND, f"HT Jacobian slice: {rel:.3e} > "
          f"{JAC_SLICE_BOUND}")
    return launches


def phase_sdvoigt_jacobian(dev, card):
    """9d: the differentiable SD-Voigt OD at full width (the bench's
    20,000-line list, seed 0), a batch of 8 one-hot T directions."""
    store = synthetic_lines(HT_LINES["n_lines"], nu_min=HT_LINES["nu_min"],
                            nu_max=HT_LINES["nu_max"], seed=0, device=dev)
    X = arange_drift_free(*HT_BAND)
    base = std_atmosphere(device=dev)
    fn = make_od_fn(store, IsoTables.load(device=dev), X, base,
                    profile="sdvoigt", differentiable=True)
    check({c[2] for c in fn.calls} <= {"sdvoigt", "full"},
          "the differentiable SD-Voigt builder planned other passes")
    p, pl, vmr = base.p, base.pl, base.vmr
    V = one_hot_batch(dev)

    def batch():
        return torch.func.vmap(lambda v: torch.func.jvp(
            lambda T_: fn(T_, p, pl, vmr), (base.T,), (v,))[1])(V)

    reset_launches()
    tan = batch()
    torch.cuda.synchronize()
    launches = read_launches()
    check(launches["sdvoigt_jvp"] > 0, "kernel sdvoigt_jvp was not launched "
          "by the differentiable SD-Voigt OD")
    check(bool(torch.isfinite(tan).all()) and tan.abs().max().item() > 0.0,
          "SD-Voigt tangents not finite or zero")
    del tan
    ms, _ = cuda_ms(batch, 1)
    print(f"[9d sdvoigt jacobian] 20000 lines, 66 layers x {X.size} points, "
          f"8 one-hot T directions: {ms:.3f} ms (CUDA events, warm); "
          f"launches {dict((k, v) for k, v in launches.items() if v)} "
          f"[{card}]", flush=True)
    return launches


def phase_ht_breakdown(dev, card):
    """10: where the time of 9, 9b and 9c goes: CUDA-event ms per kind of
    pass, each with its bound (evaluations recounted on the host)."""
    T, p = xs_states(dev)
    iso = IsoTables.load(device=dev)
    X = arange_drift_free(*HT_BAND)
    base = std_atmosphere(device=dev)
    store, extras = ht_lattice_case(dev)
    lat = make_ht_fn(store, iso, X, XS_T, np.ones_like(XS_T), extras=extras)
    lstore, lextras = ht_layered_case(dev)
    lay_fn = make_od_ht_fn(lstore, iso, X, base, extras=lextras)
    jstore, jextras = ht_jac_case(dev)
    jac = make_od_ht_fn(jstore, iso, arange_drift_free(*HT_JAC_BAND), base,
                        extras=jextras, differentiable=True)
    for label, fn, prm_fn in (
            ("9 lattice", lat, lambda: lat.line_params(T, p)),
            ("9b layered OD", lay_fn, lambda: lay_fn.line_params(
                base.T, base.p, base.pl, base.vmr)),
            ("9c jacobian primal", jac, lambda: jac.line_params(
                base.T, base.p, base.pl, base.vmr))):
        ms = {}
        ms["line params"], prm = cuda_ms(prm_fn, 3)
        work = {}
        for call in fn.calls:
            t, _ = cuda_ms(lambda: ht_primal(call, prm), 2)
            mode = call[2]
            ms[mode] = ms.get(mode, 0.0) + t
            o, b = (ht_bound_work(call[0], call[1], prm) if mode == "ht"
                    else xs_bound_work(mode, call[0], call[1], prm))
            w = work.setdefault(mode, [0, 0])
            work[mode] = [w[0] + o, w[1] + b]
        print(f"[10 {label}] ms per stage: " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items()) + "; bound ms: "
            + ", ".join(f"{m} {bound_str(*w)}"
                        for m, w in work.items()) + f" [{card}]", flush=True)
    prm = jac.line_params(base.T, base.p, base.pl, base.vmr)
    tans = ht_od_tangents(jac, base, one_hot_batch(dev))
    ms, work = {}, {}
    reads = [cuda_ms(lambda: ht_od_tangents(jac, base, one_hot_batch(dev)),
                     1)[0] for _ in range(3)]
    ms["line params + tangents"] = float(np.median(reads))
    for call in jac.calls:
        mode = call[2]
        t, _ = cuda_ms(lambda: ht_tangent(call, prm, tans), 2)
        ms[HT_TANGENT_NAME[mode]] = ms.get(HT_TANGENT_NAME[mode], 0.0) + t
        lay, dplan = call[0], call[1]
        o, b = (ht_bound_work(lay, dplan, prm, [tans[1], *tans[5:]])
                if mode == "ht" else k4_bound_work(lay, dplan, prm, tans[:5])
                if mode == "sdvoigt" else
                k3_bound_work(lay, dplan, prm, tans[:4]))
        w = work.setdefault(HT_TANGENT_NAME[mode], [0, 0])
        work[HT_TANGENT_NAME[mode]] = [w[0] + o, w[1] + b]
    print("[10 9c tangents] 8 one-hot T directions, ms per stage (line "
          f"params + tangents: median of 3, range {min(reads):.3f}-"
          f"{max(reads):.3f}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + "; bound ms: "
          + ", ".join(f"{m} {bound_str(*w)}"
                      for m, w in work.items()) + f" [{card}]", flush=True)


def phase_probe(dev, card):
    """2b: the FP32 issue-rate probe (P1/P2) against its plain chains, then
    the measured peak and the suite; the JSON entry's times and bound on one
    fma_dep workload both versions run."""
    props = torch.cuda.get_device_properties(dev)
    n = props.multi_processor_count * props.max_threads_per_multi_processor
    gen = torch.Generator().manual_seed(5)
    eps = torch.finfo(torch.float32).eps
    ab = dict(a=fp32_peak.CHECK_A, b=fp32_peak.CHECK_B)
    err_max = 0.0
    for name, op, nch in fp32_peak.SUITE:
        y0 = (0.25 + 0.75 * torch.rand((n, nch), generator=gen)).to(dev)
        for depth, iters in PROBE_CHECK:
            got = fp32_peak.probe(op, depth, iters, y0, **ab)
            want = fp32_peak.probe_plain(op, depth, iters, y0, **ab)
            err = (got - want).abs()
            ulps = (err / (eps * want.abs())).max().item()
            err_max = max(err_max, err.max().item())
            print(f"[2b probe {name}] {n} threads x {nch} chains x {depth} "
                  f"x {iters} steps: max|kernel-plain| {err.max().item():.3e}"
                  f" = {ulps:.3f} float32 ulps", flush=True)
            check(ulps <= PROBE_ULPS, f"probe {name} at depth {depth}: "
                  f"{ulps:.3f} ulps from its plain chains > {PROBE_ULPS}")
    y0 = torch.full((n, 1), 0.5, device=dev)
    work = lambda f: f("fma", fp32_peak.DEPTH, PROBE_WORK_ITERS, y0)  # noqa
    k_ms, got = cuda_ms(lambda: work(fp32_peak.probe), 5)
    p_ms, want = cuda_ms(lambda: work(fp32_peak.probe_plain), 1)
    err = (got - want).abs().max().item()
    ulps = ((got - want).abs() / (eps * want.abs())).max().item()
    check(ulps <= PROBE_ULPS, f"probe fma_dep workload: {ulps:.3f} ulps")
    steps = n * fp32_peak.DEPTH * PROBE_WORK_ITERS
    print(f"[2b probe] fma_dep workload ({n} threads x "
          f"{fp32_peak.DEPTH * PROBE_WORK_ITERS} steps): kernel {k_ms:.4f} "
          f"ms, plain {p_ms:.3f} ms, {ulps:.3f} ulps [{card}]", flush=True)
    fp32_peak.LAUNCHES.clear()
    peak, which = fp32_peak.measured_fp32_peak(dev)
    suite = fp32_peak.probe_suite(dev)
    launches = fp32_peak.LAUNCHES["fp32_peak_probe"]
    MEASURED["fp32"] = peak
    # P1's dependent FMUL chain: one lane-instruction a step
    MEASURED["issue"] = next(r["ops_per_s"] for r in suite
                             if r["probe"] == "mul_dep")
    for rec in suite:
        print(f"[2b suite] {json.dumps(rec)}", flush=True)
    print(f"[2b peak] measured FP32 peak {peak:.6g} ops/s ({which}) = "
          f"{peak / FP32_OPS_PER_S:.4f} of the data sheet's "
          f"{FP32_OPS_PER_S:.4g}; {launches} probe launches; every bound "
          f"below is stated at both [{card}]", flush=True)
    stats = {}
    add_stats(stats, "probe", max(err_max, err), k_ms, p_ms,
              2 * steps, 8 * n)
    return {"launches": launches, **finish_stats(stats)["probe"]}


def unfused_case(dev, band, dtype=torch.float32):
    """The prebuilt-plan route's inputs on ``band``, in compute_od_layers's
    order: the derived list with the CLI's margin, the partition tables, the
    axis and the standard atmosphere."""
    store = derived_lwir_linelist(band[0] - MARGIN, band[1] + MARGIN,
                                  device=dev, dtype=dtype)
    iso = IsoTables.load(device=dev, dtype=dtype)
    base = std_atmosphere(device=dev, dtype=dtype)
    X = arange_drift_free(*band)
    return store, iso, X, base


def k7_bound_work(mode, plan, prm):
    """(lane-ops, bytes) one K7 launch needs on these inputs: the in-window
    evaluations of every (layer, line) pair over the whole grid (every tile
    a window touches visits the line's block), at their region's hand count
    (the header of csrc/fused_xsect.cu), as for K1; each parameter of each
    line, each slot and each output element once."""
    n_lay, n_lines = prm.strength.shape
    dplan = fused_xsect.device_plan(plan, np.arange(n_lines), None,
                                    device="cpu")
    whole = dataclasses.replace(
        dplan, tile=dplan.n_out, n_tiles=1,
        starts=torch.zeros(1, dtype=torch.int32),
        counts=torch.tensor([plan.n_blocks], dtype=torch.int32))
    lay = torch.arange(n_lay, dtype=torch.int32)
    if mode in SIMPLE_OPS:
        return xs_bound_work(mode, lay, whole, prm)
    return k1_bound_work(mode, lay, whole, prm)


def event_ms(fn):
    """Milliseconds of one call of ``fn`` (CUDA events, no warm-up)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop), out


def phase_unfused_sub(dev, card):
    """3e: K7 in each mode against its plain version on make_od_plan's
    shared-block plan over the sub-band (derived list, 66 layers); a packed
    plan against the shared one."""
    store, iso, X, base = unfused_case(dev, SUB_BAND)
    plan = make_od_plan(store, iso, X, base)
    cols = _line_species_cols(store.host_view(), base.mol_ids)
    prm = {p: layer_line_params(store, iso, base, cols, profile=p)
           for p in ("voigt", "lorentz", "doppler")}
    prm_of = lambda m: prm[m if m in SIMPLE_OPS else "voigt"]  # noqa
    launch = lambda m: fused_xsect.xsect_unfused(plan, prm_of(m), m)  # noqa
    reset_launches()        # one counted direct launch of each mode
    for m in K7_MODES:
        launch(m)
    torch.cuda.synchronize()
    launches = read_launches()
    timed = time_kernels((f"K7 {m}", lambda m=m: launch(m))
                         for m in K7_MODES)
    runs = {}
    for m, (k_ms, k_out) in zip(K7_MODES, timed):
        p_ms, p_out = event_ms(lambda m=m: fused_xsect.xsect_unfused_plain(
            plan, prm_of(m), m))
        runs[m] = (k_ms, k_out, p_ms, p_out)
    od_peak = runs["full"][3].abs().max().item()
    stats = {}
    for m, (k_ms, k_out, p_ms, p_out) in runs.items():
        own = p_out.abs().max().item()
        check(own > 0.0, f"K7 {m}: the plain pass is zero on the band")
        err = (k_out - p_out).abs().max().item()
        peak = own if m in SIMPLE_OPS else od_peak
        rel, rel_own = err / peak, err / own
        print(f"[3e K7 {m}] 66 layers x {X.size} points, tile {plan.tile} "
              f"block {plan.block}, {plan.n_tiles} tiles, max blocks "
              f"{plan.max_blocks}: max|kernel-plain| {err:.3e} = {rel:.3e} "
              f"of the OD peak {peak:.4e} = {rel_own:.3e} of its own peak "
              f"{own:.4e}; kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms "
              f"[{card}]", flush=True)
        check(rel <= K1_BOUND, f"K7 {m}: {rel:.3e} of the OD peak > "
              f"{K1_BOUND}")
        check(rel_own <= XS_OWN_BOUND[m], f"K7 {m}: {rel_own:.3e} of its own "
              f"peak > {XS_OWN_BOUND[m]}")
        add_stats(stats, m, err, k_ms, p_ms,
                  *k7_bound_work(m, plan, prm_of(m)))
    packed = fused_xsect.plan_buckets_packed(
        store.host_view().nu0, plan.grid, plan.max_wing, tile=plan.tile,
        block="auto")
    got = fused_xsect.xsect_unfused(packed, prm["voigt"])
    rel = (got - runs["full"][1]).abs().max().item() / od_peak
    print(f"[3e K7 packed] full on a packed plan (block {packed.block}, "
          f"{packed.n_blocks} blocks) against the shared one: {rel:.3e} of "
          f"peak", flush=True)
    check(rel <= K7_PACKED_BOUND, f"K7 packed plan: {rel:.3e} of peak > "
          f"{K7_PACKED_BOUND}")
    return finish_stats(stats), launches


def members(base, n):
    """``n`` perturbed states as ``run_tud`` draws them (seed 0)."""
    draws = ensemble_draws(n, 0)
    return [dataclasses.replace(base, **dict(zip(
        ("T", "vmr"), ensemble_member(base, draws, i)))) for i in range(n)]


def phase_od_layers(dev, card):
    """11: compute_od_layers on the prebuilt-plan route at full width, with
    the launch counts reset before and read after (K7 must have run, K1 and
    K2 not); against make_od_fn on the base state; where its time goes;
    then a 5 cm^-1 band on the card and on the CPU in float64."""
    store, iso, X, base = unfused_case(dev, FULL_BAND)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plan = make_od_plan(store, iso, X, base)
    build_s = time.perf_counter() - t0
    n_cnt = int(plan.counts.sum())
    print(f"[11 route] {len(store)} lines, 66 layers, {X.size} points: "
          f"make_od_plan {build_s:.3f} s: max_wing {plan.max_wing:.6g} "
          f"cm^-1, tile {plan.tile}, block {plan.block}, {plan.n_tiles} "
          f"tiles, {plan.n_blocks} blocks, max blocks {plan.max_blocks}, "
          f"sum of counts {n_cnt}: {66 * n_cnt * plan.block * plan.tile:.4g}"
          f" slot-points a call", flush=True)
    states = members(base, OD_LAYERS_MEMBERS)
    route = lambda st: compute_od_layers(  # noqa: E731
        store, iso, X, st, engine="pallas", plan=plan, continuum="mt_ckd")
    reset_launches()
    secs, lo, hi = [], np.inf, -np.inf
    for st in states:
        t1 = time.perf_counter()
        od = route(st)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t1)
        check(od.shape == (66, X.size), f"route OD shape {tuple(od.shape)}")
        check(bool(torch.isfinite(od).all()), "route OD has non-finite "
              "values")
        lo, hi = min(lo, od.min().item()), max(hi, od.max().item())
        check(lo >= 0.0, f"route OD below zero: {lo}")
        del od
    launches = read_launches()
    print(f"[11 route] launches during {len(states)} members: "
          f"{dict(launches)}", flush=True)
    check(launches["unfused_full"] == len(states), "K7 was not launched "
          "once a member by the route")
    check(not [k for k, v in launches.items() if v and k != "unfused_full"],
          "the route launched another kernel than K7")
    print(f"[11 route] {len(states)} members, OD in [{lo:.4g}, {hi:.4g}]: "
          f"{['%.4f s' % t for t in secs]} a member (wall, synchronised) "
          f"[{card}]", flush=True)

    # against the production builder on the base state
    od_route = route(base)
    od_fn = make_od_fn(store, iso, X, base, continuum="mt_ckd")
    od_b = od_fn(base.T, base.p, base.pl, base.vmr)
    rel = (od_route - od_b).abs().max().item() / od_b.abs().max().item()
    print(f"[11 route] base state against make_od_fn(continuum='mt_ckd'): "
          f"{rel:.3e} of peak {od_b.abs().max().item():.4e}", flush=True)
    check(rel <= ROUTE_VS_BUILDER, f"route vs make_od_fn: {rel:.3e} > "
          f"{ROUTE_VS_BUILDER}")
    del od_route, od_b, od_fn

    # where a member's time goes, K7 against its plain version
    cols = _line_species_cols(store.host_view(), base.mol_ids)
    ms = {}
    ms["line params"], prm = cuda_ms(
        lambda: layer_line_params(store, iso, base, cols), 3)
    ms["K7 full"], k_out = cuda_ms(
        lambda: fused_xsect.xsect_unfused(plan, prm), 3)
    nu = torch.as_tensor(X, dtype=torch.float32, device=dev)
    ms["continuum"], _ = cuda_ms(lambda: continuum_od(nu, base, "mt_ckd"), 3)
    ms["route"], _ = cuda_ms(lambda: route(base), 3)
    p_ms, p_out = event_ms(lambda: fused_xsect.xsect_unfused_plain(plan,
                                                                   prm))
    err = (k_out - p_out).abs().max().item()
    rel = err / p_out.abs().max().item()
    check(rel <= K1_BOUND, f"K7 full at full width: {rel:.3e} of peak > "
          f"{K1_BOUND}")
    del p_out
    work = k7_bound_work("full", plan, prm)
    print(f"[11 breakdown] base state, ms per stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; K7 full vs plain {rel:.3e} of peak, plain {p_ms:.3f} ms; K7 "
          f"bound ms {bound_str(*work)} [{card}]", flush=True)
    stats = {}
    add_stats(stats, "full", err, ms["K7 full"], p_ms, *work)

    # a 5 cm^-1 band: the card against the CPU's float64 plain run, and the
    # production builder against the same float64 reference
    small = unfused_case(dev, OD_LAYERS_SMALL)
    gpu = compute_od_layers(*small, engine="pallas",
                            plan=make_od_plan(*small), continuum="mt_ckd")
    gpu_b = make_od_fn(*small, continuum="mt_ckd")(
        small[3].T, small[3].p, small[3].pl, small[3].vmr)
    t1 = time.perf_counter()
    ref64 = unfused_case("cpu", OD_LAYERS_SMALL, torch.float64)
    ref = compute_od_layers(*ref64, engine="pallas",
                            plan=make_od_plan(*ref64), continuum="mt_ckd")
    cpu_s = time.perf_counter() - t1
    peak = ref.abs().max().item()
    rel = (gpu.cpu().double() - ref).abs().max().item() / peak
    rel_b = (gpu_b.cpu().double() - ref).abs().max().item() / peak
    print(f"[11 slice] {OD_LAYERS_SMALL[0]:g}-{OD_LAYERS_SMALL[1]:g} cm^-1, "
          f"66 layers: the route on the card against the CPU's float64 plain"
          f" run ({cpu_s:.1f} s) {rel:.3e} of peak; make_od_fn on the card "
          f"against it {rel_b:.3e}", flush=True)
    check(rel <= K1_BOUND, f"route card vs CPU float64: {rel:.3e} > "
          f"{K1_BOUND}")
    check(rel_b <= K1_BOUND, f"make_od_fn card vs CPU float64: {rel_b:.3e} "
          f"> {K1_BOUND}")
    return finish_stats(stats)["full"], launches


def main():
    t0 = time.perf_counter()

    def run(phase, *args):
        """One phase, then the seconds since the start on a line of its
        own (the script's time limit is the sum)."""
        out = phase(*args)
        print(f"[t] {phase.__name__} done at {time.perf_counter() - t0:.1f} "
              "s", flush=True)
        return out

    card, name = run(phase_device)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    run(phase_build)
    warm_up(dev)
    probe = run(phase_probe, dev, card)
    k1 = run(phase_k1, dev, card)
    k1d = run(phase_k1_diff, dev, card)
    xs_stats, full_launches = run(phase_xs_sub, dev, card)
    ht_stats = run(phase_ht_sub, dev, card)
    k7, k7_launches = run(phase_unfused_sub, dev, card)
    k2 = run(phase_k2, dev, card)
    launches = run(phase_main, card)
    jac_launches = run(phase_jacobian, card)
    xs_launches = {**run(phase_xs_main, dev, card),
                   **{m: full_launches[m] for m in ("corr:64:voigtfull",
                                                    "corr:64:sdvoigtfull")}}
    ht_launches = run(phase_ht_lattice, dev, card)
    run(phase_ht_layered, dev, card)
    ht_jac_launches = run(phase_ht_jacobian, dev, card)
    run(phase_sdvoigt_jacobian, dev, card)
    k7["full"], route_launches = run(phase_od_layers, dev, card)
    run(phase_breakdown, dev, card)
    run(phase_jac_breakdown, dev, card)
    run(phase_xs_breakdown, dev, card)
    run(phase_ht_breakdown, dev, card)
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
    kernels.append({"name": "fused_ht", "route": "cuda",
                    "source": src + "fused_ht.cu", "replaces": xs + "929",
                    "launches": ht_launches["ht"], **ht_stats["ht"]})
    kernels.append({"name": "fused_ht_jvp", "route": "cuda",
                    "source": src + "fused_ht.cu", "replaces": xs + "1058",
                    "launches": ht_jac_launches["ht_jvp"],
                    **ht_stats["ht_jvp"]})
    kernels.append({"name": "fused_xsect_sdvoigt_jvp", "route": "cuda",
                    "source": src + "fused_xsect_jvp.cu",
                    "replaces": xs + "1324",
                    "launches": ht_jac_launches["sdvoigt_jvp"],
                    **ht_stats["sdvoigt_jvp"]})
    kernels += [{"name": f"unfused_xsect_{m}", "route": "cuda",
                 "source": src + "fused_xsect.cu", "replaces": xs + "659",
                 "launches": (route_launches if m == "full"
                              else k7_launches)[f"unfused_{m}"], **k7[m]}
                for m in K7_MODES]
    kernels.append({"name": "fp32_peak_probe", "route": "cuda",
                    "source": src + "peak_probe.cu",
                    "replaces": "bench.py:193, tools/vpu_peak_probe.py:62",
                    **probe})
    k2["tud"]["launches"] = launches["tud"]
    kernels.append({"name": "fused_tud", "route": "cuda",
                    "source": src + "fused_tud.cu",
                    "replaces": "radtxfr_tpu/kernels/pallas_tud.py:81",
                    **k2["tud"]})
    # planck=False: no path of the package calls it; its launch is phase
    # 4's direct one
    kernels.append({"name": "fused_tud_source_input", "route": "cuda",
                    "source": src + "fused_tud.cu",
                    "replaces": "radtxfr_tpu/kernels/pallas_tud.py:81",
                    **k2["tud_b"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
