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
   zeros or a wrong shape fails whatever the other passes add. Phases 3,
   3b, 3c, 3d and 3e run each pass in both instantiations of its kernel:
   FAST (``csrc/*_fast.cu``, the fast reciprocal, the builders' default,
   JAX's ``fast_rcp=True``) and IEEE (``fast_rcp=False``), each against
   the plain version at the same bound, printing the largest FAST - IEEE
   difference as a share of the peak. Each also counts the IEEE
   instantiations' launches on a user's path: the builders called with
   ``fast_rcp=False`` on the sub-band (the main path, phases 5-16, runs
   FAST and fails if an IEEE instantiation of a kernel with a FAST one is
   launched on it).
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
5c. The checkpointed production command (``PRODUCTION --checkpoint DIR``
   cut to 6 members in batches of 2) in child processes that this script
   writes: an uninterrupted run; a run whose child kills itself with
   SIGKILL right after its first ``batch_000000.npz`` is in place (a
   wrapper around ``EnsembleCheckpoint.write_batch`` in the child's code),
   then a fresh process that resumes it. Exactly one batch file and no
   output before the resume; the two runs' outputs byte-identical (the
   products streamed with ``np.save``, and the HDF5 files where h5py is
   installed); their tau/La/Ld equal an in-process ``run_tud`` of the same
   members without ``--checkpoint``; K1 ``asym``/``core``/``mix`` and K2
   launched in the children (their own counts). Seconds a batch with and
   without checkpoints and each ``.npz`` write.
5d. The reference (jnp) engine on the card: ``xsect --engine jnp``
   ``--profile sdvoigt`` and ``--profile ht`` on a 10 cm^-1 sub-band with
   halfwidth wings, 3 states (float32, as the CLI runs it), against the
   same on the CPU within 1e-5 of the peak; the kernel route's lattice (K1
   ``sdvoigt`` and ``full``) against the engine in float64 on the card, and
   ``compute_od_layers(profile="ht", ht_extras=...)`` on four layers on the
   kernel route (K5) against the engine in float64, each within 1e-5 of
   the peak (``tests/test_torch_xsect.py``'s SD-Voigt ``MODE_BOUND``; the
   float32 engine keeps line centres in float32, about 4e-4 of the peak
   from the kernel route, as the JAX package's two engines are, which is
   printed); ``tud --engine jnp`` on two members of phase 5's case cut to
   718-720 cm^-1 on the card against the CPU within ``SLICE_BOUND``, its
   gap to the kernel route printed; the engine's seconds on the card.
5e. The scene path on phase 5's production products (4 members, 11,513
   points reduced to 0.25 cm^-1 resolution on a 0.0625 cm^-1 axis, 9
   altitudes; the K1 and K2 launches of the
   ``tud`` that made them printed): ``run_planck`` against the CPU's
   float64 within 1e-6 of peak, its brightness-temperature round trip
   within ``PLANCK_BT_BOUND``; ``run_mako`` against the same call on
   the CPU in float64 within 1e-6 of peak; ``run_radiance`` at the CLI
   defaults (24 materials, dT -10..10 K by 0.5) on those products and on
   the MAKO products tiled to 1000 atmospheres (the reference's
   ``Compute_LWIR_Apparent_Radiance`` shape), each against the CPU's
   float64 result on its first atmospheres within 1e-6 relative, L > 0;
   ``run_hsi`` at the CLI defaults (100 pixels, 3 atmospheres) and on a
   100 x 100 scene: fractions summing to 1, labels in range, L finite,
   the card's draws re-composed on the CPU in float64 within 1e-6
   relative; ``run_emis --mixtures --mako --features 16`` (its NMF core
   on the card, float32, against the CPU's float64 from the same initial
   factors within ``NMF_BOUND`` of the reconstruction's peak) and
   ``run_atmosgen`` at the CLI defaults and at ``--n-ensemble 1000`` (the
   variational fit's core on the card against the CPU from the same
   initial indices, float64: weights and the rows' log-density within
   ``BGMM_WEIGHT_BOUND`` and ``BGMM_LOGP_BOUND`` of peak; the profiles T > 0,
   no supersaturated layer, counts and labels in range); the launch
   counts are reset before the commands and read after them, and any
   kernel launch fails the phase. Each command's
   seconds (a second, warm call; host clock, results on the host), and
   those of the fixed-count loops (NMF's 400 updates, FastICA's 200, the
   variational fit's 500 steps and EM's 200). Then the products chained
   on the card as JAX's chain on a device: one production member at full
   width (standard atmosphere, line mixing, MT_CKD; its K1 and K2
   launches counted) composed by ``make_tud_fn`` on the state's card
   ``z0`` and card altitudes, ``ils_mako(t.X, t.tau)``,
   ``reduce_operator(t.X, 0.25)`` on ``t.tau``, ``write_h5`` (a recording
   stand-in for h5py where it is not installed) and
   ``EnsembleCheckpoint.write_batch``, every step fed card tensors and
   bit-identical to the same call on host copies; each step's seconds.
5b. The Jacobian path: ``run_tud`` on the production configuration with
   ``--jacobian`` (d tau/Lu/Ld / d T, H2O, O3: 198 directions) with the
   launch counts reset before and read after (K1 ``full`` and K3 must have
   run); the six Jacobians' shapes, finite values, wall seconds and peak
   device memory. Then the same on a 2 cm^-1 band (718-720 at 5e-3
   cm^-1) on the card and on the CPU: each Jacobian within 1e-4 of its
   own peak.
6. Where one member's time goes (CUDA events per stage), with each K1
   mode's bound at the production width; beside each pass's in-window
   evaluations (``window_counts``: what the kernels evaluate after
   culling), its builder's ``work_report`` entry (the plan's dense
   (layer x slot x point) work, JAX's ``plan_executed_evals``), each
   labelled, and the per-mode totals of both.
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
   ``K4_BOUND`` and ``K3_BOUND`` of each tangent's own peak; each K5, K6
   and K4 pass's bound at 67 TFLOP/s and in issue slots (K6 and K4 also
   charging every live pair all the batch's directions), and the SASS
   lane-instructions of each piece of their evaluations.
9. The HT lattice at full width (the JAX bench's metric 5: 400,001 points,
   10 states) with the launch counts reset before and read after (K5 must
   have run): plan-build seconds, CUDA-event milliseconds, states and
   window evaluations per second; a small lattice on the card and the CPU
   within 1e-5 of peak; ``xsect --profile ht`` through the CLI on the
   coarse-far route, AFIT files written and one read back.
9b. The layered HT OD at full width (metric 5b: 66 layers): milliseconds,
   window evaluations per second, the K5 and K1 launch counts. The window
   evaluations of 9 and 9b come from ``ht_wing_bounds`` on the card's
   isotopologue tables and states, held equal to the call on host
   copies.
9c. The HT Jacobian (``ht_jacobian_jvp_per_s``: 2,000 lines, 790-830
   cm^-1): d OD / d T[3], then all 66 one-hot T directions through ``vmap``
   of ``jvp`` with the counts reset before and read after (K3, K4 and K6
   must have run): wall seconds, directions per second, peak device
   memory; d OD / d T[3] on a small band on the card and on the CPU within
   1e-4 of its peak.
9d. The differentiable SD-Voigt OD at full width (the bench's 20,000-line
   list): a batch of 8 one-hot T directions, milliseconds and launches
   (K4 must have run); then where its tangent time goes: the line
   parameters with their tangents, K4 on the sdvoigt passes and K3 on the
   full ones, milliseconds, launches and bounds (K4 and K3 also in issue
   slots and charging every live pair all 8 directions); K4's output of
   each sdvoigt pass (its 512-point tiles, four slices each) held against
   its plain version on four tiles from 800 cm^-1, for the batch and for a
   T direction over all layers, each direction within ``K4_BOUND`` of its
   own peak, the band holding pairs of both Weideman-range forms (closed
   form, and the whole window near tangency).
10. Where the time of 9, 9b and 9c goes: CUDA-event milliseconds per kind
   of pass, each with its bound (K4, K5 and K6 also in issue slots), and
   the tangent kernels' launches in the 9c batch.
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
   bound, the continuum) and K7 (IEEE, the route's default, and FAST)
   against its plain version at full width; the route with
   ``pallas_opts={'fast_rcp': True}`` once, its K7 FAST launch counted;
   the route on a 5 cm^-1 band on the card against the CPU's float64 plain
   run, and make_od_fn on the card against the same run, each within 2e-6
   of peak.
12. The sharded production path (``dist/fused_ensemble.py``) at phase 5's
   full width on a virtual (2 x 2) mesh whose entries are all the one
   card (every shard plan, tile offset and gather runs; the shards run one
   after another, so this is the cost of sharding on one card, never a
   multi-card speed-up): ``make_tud_ensemble_fn`` on phase 5's 4 members
   with the equal and the weighted partition, the launch counts reset
   before and read after (K1 asym/core/mix with tile offsets, K2), tau,
   Lu and Ld against the unsharded builder on the same padded grid, class
   and options within K2's 5e-6 of peak, bit-identity stated; the
   gathered OD against the unsharded OD within 2e-6 of peak; each shard's
   K1 passes on ``SHARD_EDGE_TILES`` tiles at each end (their offsets
   carried over) against their plain versions within K1's bounds and
   equal to the whole shard's columns; where a sharded member's time goes
   (line parameters, K1, continuum, K2, gather) beside the unsharded
   member; one sharded Jacobian batch of 8 directions (K1 ``full`` and K3
   with offsets) against the unsharded ``jvp`` within 1e-4 of each
   tangent's peak; K4 with offsets on the differentiable SD-Voigt OD of
   phase 9c's lines (8 one-hot T directions, 2 weighted shards) against
   unsharded within ``K4_BOUND``; the line-sharded OD on 2 shards against
   the replicated one within 2e-6 of peak; ``run_tud`` with ``--mesh-*``
   on the virtual mesh against phase 5's ``run_tud`` products within
   ``MESH_VS_MAIN_BOUND`` (its plans sized on each batch's envelope, phase
   5's on the base state, whose wing bounds clamp the colder members'
   wings), and with ``--checkpoint`` (in this process; phase 5c kills and
   resumes the single-device command in child processes): the
   checkpointed products, and those of a run resumed after the second
   batch file was removed (only that batch computed, through K1 and K2),
   bit-identical to the run without checkpoints.
13. The cross-section serving path at the reference generator's width
   (``misc/RT_gen_AbsXS_files.py:15-31``): for molecules 1 and 2 of the
   ``XS_CLI`` list, one at a time, ``make_xsect_fn`` on the (T, p) lattice
   275-320 K by 5 x 0.85-1.05 atm by 0.05 (50 states), 400-7100 cm^-1 at
   0.0025, SD-Voigt with 350 cm^-1 wings, the launch counts reset before
   and read after (K1 ``sdvoigt_asym``, ``corr:64:sdvoigt`` and
   ``sdvoigt_core`` must have run); each molecule's 50 rows on the
   1000-1010 cm^-1 sub-band: every K1 pass of the sub-band's lattice at
   the same lines and 50 states, coarse-far and classic, against its plain
   version (``XS_BOUND``, ``XS_OWN_BOUND``), and the rows within
   ``COARSE_BOUND`` of that classic lattice; the 100 rows written with
   ``xs_write``
   and read back by ``xs_table_from_files``, equal to the kernel's rows bit
   for bit; ``od_from_xs`` at a lattice node (300 K, 0.95 atm) within
   2e-6 of peak of the column times the kernel's row; on phase 5's 4
   members, composed by K2 (``make_tud_fn``, 9 altitudes, 30 angles; K2
   launched once a member), the card's float32 OD within 1e-6 of peak of
   a CPU float64 ``od_from_xs`` on the same table and inputs over
   690-1410 cm^-1, K2 within 5e-6 of ``tud_from_od`` on the served OD,
   products finite, 0 <= tau <= 1, La and Ld > 0; the lattice's, the
   files', ``od_from_xs``'s (``"highest"`` and ``"default"``, against its
   byte and FLOP bounds) and K2's times and a served member's wall
   seconds.
14. Each example of ``examples/torch/`` (01-05; 03 the hapi drop-in) as a
   child process on the card (``EXAMPLE_TIMEOUT`` seconds each): exit 0 and
   ``OK`` last.
15. The hapi drop-in and the reference-signature layer. (a)
   ``compat.compute_TUD(690, 1410, lines=<the derived list on the card>,
   engine="pallas", continuum="mt_ckd")`` at ``DVOUT`` 5e-4 (66
   ``StdAtmos`` layers, ``Altitudes`` [500], ``N_angle`` 30) with the
   launch counts reset before and read after (K1 ``asym`` and ``core`` must
   have run, K2 not: ``tud_from_od`` is plain torch) and the peak device
   memory: finite, 0 <= tau <= 1, Lu and Ld > 0, bit-identical to
   ``compute_od_layers(engine="pallas")`` + ``tud_from_od`` on the same
   inputs and to a second call, whose wall seconds it prints. (b)
   ``compat.compute_OD`` on the reference engine (float64) over 1000-1010
   cm^-1 at 0.0025, card against CPU within 1e-10 of peak. (c) The reference
   generator's hapi call (``misc/RT_gen_AbsXS_files.py:87-92``) in hapi's
   names: the ``XS_CLI`` list written as a hapi table with its ``SD_air``
   column, opened by ``db_begin(dir, device=...)``, and
   ``absorptionCoefficient_SDVoigt(Components=[(M, 1)], OmegaStep=0.0025,
   OmegaWing=350, HITRAN_units=True)`` for H2O and CO2 at the generator's
   corner states (275 and 320 K; 0.85 and 1.05 atm), cut to 1000-1010
   cm^-1, then the Voigt, Lorentz, Doppler and HT drivers once: card
   against CPU (both float64; the SD-Voigt call at one corner a molecule,
   ``HAPI_CPU_STATES``) within 1e-7 of peak (SD-Voigt and HT, pcqsdhc's
   cancellation) or 1e-10; the seconds of each call on each device; the gap to the K1 lattice (``make_xsect_fn``, float32) on the
   same lines and states, printed without a bound. (d)
   ``radianceSpectrum`` and ``convolveSpectrum`` with each of the seven
   slits on (c)'s output, card against CPU within 1e-12 of peak.
16. The sharded production path on a mesh that spans two processes
   (``span_child``): two child processes, both on cuda:0, join one gloo
   group (``init_multihost`` on 127.0.0.1) once the kernels are built. (a)
   ``make_tud_ensemble_fn`` on phase 12's production batch at full width,
   on the (2 x 2) mesh whose ensemble row e belongs to process e, both
   partitions: each process computes its two entries and receives the
   others' through the group; its gathered tau/Lu/Ld bit-identical (SHA-256)
   to phase 12's one-process virtual mesh and to the other process's copy.
   (b) ``make_mesh(2, 1)`` without devices: one card a process, its
   ensemble on 718-723 cm^-1 bit-identical to a one-process virtual mesh;
   ``make_mesh(2, 2)`` raises. (c) One Jacobian batch of phase 12's 8
   directions, 4 a process, bit-identical to phase 12's. (d) K1 ``asym``,
   ``core``, ``mix`` and K2 (and K1 ``full``, K3 in (c)) launched in each
   process, with tile offsets. (e) Each process's ms a batch, the ms at
   which its own entries were done (synchronised) and the exchange's
   (``share_parts``, timed after a barrier of both), beside phase 12's
   one-process ms: the cost of spanning processes on one card, not a
   multi-card speed-up.
   Either child failing or past its timeout fails the phase; process 0
   alone writes the records.

Each kernel's bound is the larger of its bytes over 3.35 TB/s and its
operations over the card's rate for them (67 TFLOP/s FP32; K2's
exponentials also over the special-function units), with the evaluations
the kernel needs recounted on the host from the plans and the line
parameters (``window_counts``); K3's and K4's count each live
evaluation's shared work once and each live (pair, direction) product's
term, the kernels skipping the rest (phases 3b, 3d, 9d and 10 also print
the count that charges every live pair all 8 directions). The JSON line
also carries the bound at the measured FP32 peak
(``bound_ms_measured_peak``), and for K1's production modes, ``full``,
K3, K4, K5, K6, each K7 mode and K2 in issue slots
(``bound_ms_issue``: the SASS lane-instructions that the needed work takes,
the line shape's arithmetic of each needed evaluation (K7: K1's count of
the same shape plus the compensated add's FADDs) or K2's source and carry
steps, counted from the built library by
``radtxfr_tpu_torch/tools/sass.py`` without the kernel's window tests,
indexing or loop code, over 4 x 32 lanes x 132 SMs x 1.98 GHz, or the
special-function ops or bytes where those take longer;
``bound_ms_issue_measured``: the instructions over phase 2b's measured
FMUL-chain rate).

It ends with one JSON line of kernel results, each kernel with a FAST
instantiation listed twice: ``<name>_fast`` (``"fast_rcp": true``, its
launches on the main path) and ``<name>`` (the IEEE one, its launches on
the ``launch_path`` named: a builder with ``fast_rcp=False`` on phase 3's
sub-bands, K7's phase 11 route and phase 3e's direct launches) (K1's
production modes,
``full``, K3 and K4 also with ``offset_launches``: their launches with
tile offsets in phase 12; K1's lattice modes and K2 also with
``serving_launches``: their launches on phase 13's path; K1 ``asym`` and
``core`` also with ``compat_launches``: their launches in phase 15's
``compat.compute_TUD``; K1's production modes, ``full``, K3, K2 and K2's
tangent mode also with ``span_launches``: their launches in each of phase
16's two processes; K2's tangent mode also with ``cli_launches``, its
launches in phase 5b), and, last, the device line.
Each instantiation is held against the plain version of its own
arithmetic at the pass's bound: the IEEE one against the plain version
with IEEE division, the FAST one against the plain version with
``fast=True``, which on the card takes the FAST instantiation's reciprocal
at the same sites (``fused_xsect.card_fast_rcp``: the card's
``rcp.approx.f32`` table and the Newton step, in PyTorch). The SD-Voigt
passes sdvoigt_asym, sdvoigt_core and corr:64:sdvoigt (3c, 13) and K4 (9d)
are also held against their plain versions in float64 on the same
parameters, beside the IEEE instantiation and the float32 plain version
with IEEE division (the ``[float64]`` lines): FAST no further from the
float64 result than that float32 plain version is, plus the pass's bound.
A failed check raises at once: the script exits non-zero without the last
line. There is no CPU fallback.
"""

import collections
import contextlib
import dataclasses
import functools
import hashlib
import io
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import types

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from radtxfr_tpu_torch import _build  # noqa: E402
from radtxfr_tpu_torch.atmos.profile import std_atmosphere  # noqa: E402
from radtxfr_tpu_torch.cli.main import (  # noqa: E402
    build_parser, ensemble_draws, ensemble_member, run_tud, run_xsect,
    write_xs)
from radtxfr_tpu_torch.io.afit_xs import xs_read, xs_write  # noqa: E402
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
    resolve_ht_columns, xsect_ht)
from radtxfr_tpu_torch.kernels.xsect import xsect_from_params  # noqa: E402
from radtxfr_tpu_torch.kernels.fused_xsect import (  # noqa: E402
    _ops_per_eval, plan_executed_evals)
from radtxfr_tpu_torch.products.od_from_xs import (  # noqa: E402
    XsTable, od_from_xs, xs_table_from_files)
from radtxfr_tpu_torch.core.constants import PA_PER_ATM  # noqa: E402
from radtxfr_tpu_torch.products.od import (_coarse_upsample,  # noqa: E402
                                           _line_species_cols,
                                           compute_od_layers, ht_wing_bounds,
                                           layer_line_params, make_ht_fn,
                                           make_od_fn, make_od_ht_fn,
                                           make_od_plan, make_xsect_fn,
                                           species_column)
from radtxfr_tpu_torch.atmos.continuum import continuum_od  # noqa: E402
from radtxfr_tpu_torch.tools import fp32_peak, sass  # noqa: E402
from radtxfr_tpu_torch.products.tud import (_layers_below,  # noqa: E402
                                            downwelling_quadrature,
                                            make_tud_diff_fn, make_tud_fn,
                                            tud_from_od)
from radtxfr_tpu_torch.sensor.resolution import (  # noqa: E402
    reduce_operator, reduce_resolution)
from radtxfr_tpu_torch.tools import e2e_drive  # noqa: E402
from radtxfr_tpu_torch.dist.checkpoint import EnsembleCheckpoint  # noqa: E402
from radtxfr_tpu_torch.io.h5 import Var, read_h5, write_h5  # noqa: E402
from radtxfr_tpu_torch.sensor.ils import ils_mako  # noqa: E402
from radtxfr_tpu_torch.atmos.profile import std_atmosphere_raw  # noqa: E402
from radtxfr_tpu_torch.cli.main import (  # noqa: E402
    atmosgen_ensemble, run_atmosgen, run_emis, run_hsi, run_mako,
    run_planck, run_radiance)
from radtxfr_tpu_torch.scene.emis_features import (  # noqa: E402
    _fast_ica, _nmf, od_transform)
from radtxfr_tpu_torch.scene.emissivity import synthetic_db  # noqa: E402
from radtxfr_tpu_torch.scene.generative import (  # noqa: E402
    _airmass_features, _bgmm_fit, _gmm_fit, gmm_log_prob, rh_filter)
from radtxfr_tpu_torch.scene.hsi import _hsi_compose  # noqa: E402
from radtxfr_tpu_torch.sensor.ils import mako_axis_wn  # noqa: E402
import radtxfr_tpu_torch.compat as rt  # noqa: E402
from radtxfr_tpu_torch import hapi_compat as hc  # noqa: E402
from radtxfr_tpu_torch.atmos.profile import AtmosphericState  # noqa: E402
from radtxfr_tpu_torch.lines.hapi_db import save_table  # noqa: E402
from radtxfr_tpu_torch.lines.store import LineStore  # noqa: E402

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
# K2's tangent mode against its plain version, each direction's worst gap
# over its own peak (the primal is K2's, held to K2_BOUND)
K2_JVP_BOUND = 1e-5
K2_JVP_DIRS = 8
SLICE_BOUND = 1e-5
JAC_SLICE_BOUND = 1e-4
# phase 5c: the production command with checkpoints, cut to 6 members
CHECKPOINTED = PRODUCTION.replace("--n-atmos 4", "--n-atmos 6")
CHILD_TIMEOUT = 300
# phase 5d: the reference engine's lattices (halfwidth wings) and layered
# HT OD against the kernel route, within tests/test_torch_xsect.py's
# SD-Voigt MODE_BOUND; its TUD on phase 5's small case cut to 718-720
# cm^-1 (the CPU's engine takes about a minute a member at 718-723 on a
# slow host), card against CPU
JNP_XS = ("xsect --synthetic 2000 --numin 1000 --numax 1010 --dv 0.0025 "
          "--T 280 --T-max 290 --T-step 5")
JNP_BOUND = 1e-5
JNP_HT_LAYERS = [0, 10, 25, 45]
JNP_TUD = ("tud --derived --line-mixing --continuum mt_ckd --numin 718 "
           "--numax 720 --dv 0.0005 --n-atmos 2 --batch 2")
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
# the SD-Voigt passes that also run against a float64 plain version on the
# same line parameters (check_xs_passes, float64 line)
F64_MODES = ("sdvoigt_asym", "sdvoigt_core", "corr:64:sdvoigt")
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
# 4e3 form far out); K6 adds 5 per direction to accumulate. cpf3_test
# (|Z1|, |Z2| and PART4's CPF3 test) is charged only where a CPF point lies
# in its Weideman region (the kernels skip it in spans outside every
# region); pair4 and pair1 are the point-independent values (ht_pair),
# once per (layer, line) with an in-window point
HT_PIECES = {"part4": (133, 3, 202), "cpf3_test": (18, 0, 0),
             "part1": (71, 0, 107), "part1_big": (88, 0, 132),
             "w_wei": (41 + 7 * N_WEI, 2, 65 + 14 * N_WEI),
             "w_asym": (25, 1, 40), "pair4": (63, 0, 81), "pair1": (5, 0, 1)}
HT_ACC_DIR = 5
# K4 (csrc/fused_xsect_jvp.cu "Bound."): the window, dnu, xi, S and the
# denominator 37 an evaluation, per CPF point a (K, Kx, Ky) after its 3-op
# region test (Weideman 49 + 15 n_wei or the asymptotic form's 38), 32 per
# live direction (its term with K1 - K2, and the add)
K4_BASE, K4_DIR = 37, 32
KG_WEI, KG_ASYM = 3 + 49 + 15 * N_WEI, 3 + 38


def cpf_pair_ops(n_win, n_in, w_in, w_out):
    """The two CPF points' w(Z) of ``n_win`` evaluations, of which
    ``n_in[i]`` lie in point i's Weideman region."""
    return sum(n * w_in + (n_win - n) * w_out for n in n_in)


def one_hot_batch(dev):
    """The 8 one-hot T directions of layers 24-31 (one Jacobian batch)."""
    return torch.eye(66, device=dev)[24:32]


# K3 (csrc/fused_xsect_jvp.cu "Bound."): lane-ops of a live evaluation's
# (K, Kx, Ky) and K + x Kx + y Ky inside and outside |x| + y < 15, and of
# each live direction's term (four products, three adds, the accumulate)
K3_OPS = (48 + 16 * N_WEI, 54, 8)
# the compensated (Kahan) add's FADDs a K7 evaluation adds to K1's one
# FFMA that scales and adds it (csrc/fused_xsect.cu, K7 "Sums.")
KAHAN_ADDS = 3


def check(ok, msg):
    if not ok:
        raise AssertionError(msg)


def fk(key):
    """The launch key of ``key``'s FAST instantiation (the fast
    reciprocal): what the builders launch at their default, JAX's
    ``fast_rcp=True``."""
    return fused_xsect.launch_key(key, True)


def params64(prm):
    """``prm`` (line parameters) in float64: the same float32 values, for a
    plain version that rounds nothing of the kernel's arithmetic."""
    return dataclasses.replace(prm, **{
        f.name: getattr(prm, f.name).double()
        for f in dataclasses.fields(prm)})


def f64_gaps(outs, ref, peak):
    """Each of ``outs`` (name -> output) against the float64 ``ref``, as a
    share of ``peak``: the FAST instantiation's next to the IEEE one's and
    the float32 plain version's, to tell a kernel at fault from a bound
    that asks the FAST one to replay the plain version's rounding."""
    return {k: (v.double() - ref).abs().max().item() / peak
            for k, v in outs.items()}


def fast_gap(label, fast_out, ieee_out, peak, card):
    """Print the FAST instantiation's largest difference from the IEEE
    one's on the same inputs, as a share of ``peak``; returns it."""
    gap = (fast_out - ieee_out).abs().max().item() / peak
    print(f"[fast_rcp] {label}: max|FAST - IEEE| {gap:.3e} of the peak "
          f"{peak:.4e} [{card}]", flush=True)
    return gap


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


def window_counts(lay, dplan, prm, live=None, cap=True, region="voigt",
                  pairs=False):
    """The evaluations one pass needs, recounted on the host from its plan
    and the line parameters: the in-window (layer, line, point) triples, a
    tuple with the number of them inside each radius of ``region``
    (region_radii), and the number of distinct lines the pass reads (with
    ``pairs``, also the number of (layer, line) pairs with an in-window
    point).
    ``live`` (nLay, L) bool keeps only the pairs a tangent kernel evaluates
    (a non-zero tangent) or a part of the HT lines; as integers it also
    weights each pair's evaluations (K3's live directions of the pair; not
    with ``region`` 'ht*', whose replayed points are counted once); ``cap``
    False masks by the true window (the correction passes)."""
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
    n_win, n_in, n_pairs = 0, None, 0
    for li in lay.cpu().numpy():
        w = h["wing"][li, g]
        w = (np.minimum(w, wcap) if cap else w) / dplan.dx
        # integers k with c - w < k <= c + w inside the slot's tile
        lo = np.maximum(np.floor(c - w) + 1, lo_t)
        hi = np.minimum(np.floor(c + w), hi_t)
        keep = hi >= lo
        wgt = 1
        if live is not None:
            wgt = live[li, g]
            keep &= wgt > 0
        n_win += int(((hi - lo + 1) * wgt)[keep].sum())
        n_pairs += int(np.unique(g[keep]).size)
        centre, radii, direct = region_radii(region, h, li, g)
        mid = c + centre / dplan.dx
        n_in = n_in or [0] * len(radii)
        for i, r in enumerate(radii):
            r = r / dplan.dx
            clo = np.maximum(np.floor(mid - r) + 1, lo)
            chi = np.minimum(np.ceil(mid + r) - 1, hi)
            kc = keep & (r > 0.0) & (chi >= clo)
            n_in[i] += int(((chi - clo + 1) * wgt)[kc].sum())
        if direct is not None and (keep & direct).any():
            sel = keep & direct
            for i, n in enumerate(ht_point_counts(h, li, g[sel], c[sel],
                                                  lo[sel], hi[sel],
                                                  dplan.dx)):
                n_in[i] += n
    out = (n_win, tuple(n_in or ()), int(np.unique(g).size))
    return out + (n_pairs,) if pairs else out


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
def sass_listing(stem, inline=False):
    """The parsed SASS of the built library of ``csrc/<stem>.cu`` (with
    ``inline``, each instruction's chain of inlined call sites)."""
    path = next(p for p in _build.build()
                if os.path.basename(p).rsplit("_", 1)[0] == f"lib{stem}")
    return sass.parse(sass.disassemble(path, inline))


def csrc_text(stem):
    with open(os.path.join(_build.CSRC, f"{stem}.cu")) as f:
        return f.read()


def kernel_sass(stem, pattern, fast=False):
    """The SASS of the one kernel of ``csrc/<stem>.cu`` whose mangled name
    matches ``pattern`` (``fast``: in the library of its FAST build,
    ``csrc/<stem>_fast.cu``), each instruction at its innermost source line
    in ``<stem>.cu`` (an included header's own code, such as the reciprocal
    of k1_skeleton.cuh::rcp, at the line that calls it), the instructions of
    included headers called from nowhere in it left out."""
    out = []
    for i in sass.kernel(sass_listing(f"{stem}_fast" if fast else stem,
                                      True), pattern):
        at = next((ln for f, ln in i.chain if f == f"{stem}.cu"), None)
        if at is not None:
            out.append(sass.Instr(f"{stem}.cu", at, i.op, i.pred))
    return out


@functools.lru_cache(maxsize=None)
def k1_issue(mode, fast=False):
    """SASS lane-instructions one K1 evaluation in ``mode`` (asym, core, mix,
    full, lorentz, doppler; the pass without SPLIT) needs: its line shape's
    arithmetic inside and outside |x| + y < 15
    (``sass.k1_eval_instructions``, ``sass.ld_eval_instructions``); ``fast``
    of the FAST instantiation."""
    code = fused_xsect.MODES.index(mode)
    instrs = kernel_sass("fused_xsect",
                         rf"fused_xsect_kernelILi{code}ELb0ELb0E", fast)
    if mode in SIMPLE_OPS:
        return sass.ld_eval_instructions(instrs, csrc_text("fused_xsect"),
                                         code)
    return sass.k1_eval_instructions(instrs, csrc_text("fused_xsect"), code,
                                     N_WEI)


@functools.lru_cache(maxsize=None)
def k3_issue(fast=False):
    """SASS lane-instructions a K3 evaluation needs inside and outside
    |x| + y < 15, and per live direction (``sass.k3_eval_instructions``);
    ``fast`` of the FAST instantiation."""
    return sass.k3_eval_instructions(
        kernel_sass("fused_xsect_jvp", r"fused_xsect_jvp_kernel", fast),
        csrc_text("fused_xsect_jvp"), N_WEI)


@functools.lru_cache(maxsize=None)
def ht_issue(tan, fast=False):
    """SASS lane-instructions of each piece of a K5 (``tan`` False) or K6
    evaluation, per kept pair and to accumulate
    (``sass.ht_eval_instructions``); ``fast`` of K5's FAST
    instantiation."""
    return sass.ht_eval_instructions(
        sass.kernel(sass_listing("fused_ht_fast" if fast else "fused_ht",
                                 True),
                    rf"fused_ht_kernelILb{int(tan)}ELb{int(fast)}E"),
        csrc_text("fused_ht"), N_WEI)


@functools.lru_cache(maxsize=None)
def k4_issue(fast=False):
    """SASS lane-instructions of a K4 evaluation's shared work, of a CPF
    point inside and outside |x| + y < 15, and of a live direction's term
    (``sass.k4_eval_instructions``); ``fast`` of the FAST instantiation."""
    return sass.k4_eval_instructions(
        sass.kernel(sass_listing("fused_xsect_jvp_fast" if fast
                                 else "fused_xsect_jvp", True),
                    r"fused_sdvoigt_jvp_kernel"),
        csrc_text("fused_xsect_jvp"), N_WEI)


def k1_issue_work(mode, lay, dplan, prm, counts=None, fast=False):
    """The lane-instructions one K1 pass needs: each in-window evaluation at
    its region's SASS count (``fast``: the FAST instantiation's)."""
    n_win, (n_core,), _ = counts or window_counts(lay, dplan, prm)
    c = k1_issue(mode, fast)
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


def live_directions(tangents):
    """(nd, nLay, L) bool: where each direction's (nd, nLay, L) tangents
    are non-zero."""
    live = None
    for t in tangents:
        nz = (t != 0).cpu().numpy()
        live = nz if live is None else live | nz
    return live


def live_pairs(tangents):
    """(nLay, L) bool: the pairs where any of the (nd, nLay, L) tangents is
    non-zero."""
    return live_directions(tangents).any(axis=0)


def k3_bound_work(lay, dplan, prm, tangents, fast=False):
    """(lane-ops, bytes, lane-instructions, lane-ops counting every
    direction) of one K3 launch set for the (nd, nLay, L) tangents: each
    live (pair, point) evaluation's (K, Kx, Ky) once, at its region's count,
    and each live direction's term of it (the kernel evaluates only those);
    the same in the SASS lane-instructions of ``k3_issue`` (``fast``: the
    FAST instantiation's); and the count
    that charges every pair all nd directions' terms, as a dense direction
    axis would."""
    live = live_directions(tangents)
    n_win, (n_core,), n_lines = window_counts(lay, dplan, prm,
                                              live.any(axis=0))
    n_dir = window_counts(lay, dplan, prm, live.sum(axis=0))[0]
    ops_in, ops_out, per_dir = K3_OPS
    nd, nl = len(live), lay.numel()
    nbytes = (4 * (5 + 4 * nd) * nl * n_lines + 16 * dplan.k_line.numel()
              + 4 * nd * nl * dplan.n_out)
    ops = n_core * ops_in + (n_win - n_core) * ops_out
    c = k3_issue(fast)
    instr = (n_core * c["in"] + (n_win - n_core) * c["out"]
             + n_dir * c["dir"])
    return ops + per_dir * n_dir, nbytes, instr, ops + per_dir * nd * n_win


def phase_k1(dev, card):
    """3: every pass of the production OD builder on the sub-band in both
    instantiations against its plain version; returns the passes' JSON
    fields (IEEE under the mode, FAST under ``fk(mode)``) and the IEEE
    instantiations' launches of make_od_fn(fast_rcp=False) there."""
    f32 = torch.float32
    store = derived_lwir_linelist(SUB_BAND[0] - MARGIN, SUB_BAND[1] + MARGIN,
                                  device=dev, dtype=f32)
    iso = IsoTables.load(device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(*SUB_BAND)
    y = y_air_for_store(store.host_view())
    # the builder's default, JAX's fast_rcp=True (the FAST instantiation),
    # and the same plans with fast_rcp=False (the IEEE one)
    od_fn = make_od_fn(store, iso, X, base, continuum="mt_ckd",
                       line_mixing={"y_air": y})
    od_ieee = make_od_fn(store, iso, X, base, continuum="mt_ckd",
                         line_mixing={"y_air": y}, fast_rcp=False)
    check(od_fn.fast_rcp and not od_ieee.fast_rcp
          and [c[2] for c in od_fn.calls] == [c[2] for c in od_ieee.calls],
          "3: the two builders must plan the same passes")
    prm, Y = od_fn.line_params(base.T, base.p, base.pl, base.vmr)
    line_od = torch.zeros((base.n_layers, X.size), dtype=f32, device=dev)
    runs = []
    launches = []
    for call, call_i in zip(od_fn.calls, od_ieee.calls):
        launches += [
            (f"K1 {call[2]} FAST", lambda c=call: od_fn.run_call(c, prm, Y)),
            (f"K1 {call[2]}", lambda c=call_i: od_ieee.run_call(c, prm, Y))]
    timed = iter(time_kernels(launches))
    for call, call_i in zip(od_fn.calls, od_ieee.calls):
        (f_ms, f_out), (i_ms, i_out) = next(timed), next(timed)
        # each instantiation against the plain version of its own
        # arithmetic (fast: the card's fast reciprocal)
        p_ms, p_out = cuda_ms(lambda: od_fn.run_call(
            call, prm, Y, kernel=fused_xsect.xsect_fused_plain), 1)
        pi_ms, pi_out = cuda_ms(lambda: od_ieee.run_call(
            call_i, prm, Y, kernel=fused_xsect.xsect_fused_plain), 1)
        line_od[call[0].long()] += pi_out
        own = pi_out.abs().max().item()
        runs.append((call, [
            (True, f_ms, (f_out - p_out).abs().max().item(), p_ms),
            (False, i_ms, (i_out - pi_out).abs().max().item(), pi_ms)],
            own, (f_out - i_out).abs().max().item()))
    stats = {}
    for (lay, dplan, mode), variants, own, gap in runs:
        check(own > 0.0, f"K1 {mode}: the plain pass is zero on the band")
        peak = line_od[lay.long()].abs().max().item()
        counts = window_counts(lay, dplan, prm)
        for fast, k_ms, err, p_ms in variants:
            name = f"K1 {mode}{' FAST' if fast else ''}"
            rel, rel_own = err / peak, err / own
            print(f"[3 {name}] layers {lay.numel()} tile {dplan.tile} block "
                  f"{dplan.block} tiles {dplan.n_tiles}: max|kernel-plain| "
                  f"{err:.3e} = {rel:.3e} of the layers' line-OD peak "
                  f"{peak:.4e} = {rel_own:.3e} of the pass's own peak "
                  f"{own:.4e}; kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms "
                  f"[{card}]", flush=True)
            check(rel <= K1_BOUND, f"{name}: {rel:.3e} of the "
                        f"line-OD peak > {K1_BOUND}")
            check(rel_own <= K1_OWN_BOUND[mode], f"{name}: "
                        f"{rel_own:.3e} of the pass's own peak > "
                        f"{K1_OWN_BOUND[mode]}")
            add_stats(stats, fk(mode) if fast else mode, err, k_ms, p_ms,
                      *k1_bound_work(mode, lay, dplan, prm, counts),
                      instr=k1_issue_work(mode, lay, dplan, prm, counts,
                                          fast))
        print(f"[fast_rcp] 3 K1 {mode} layers {lay.numel()}: max|FAST - "
              f"IEEE| {gap / peak:.3e} of the line-OD peak, "
              f"{gap / own:.3e} of the pass's own peak [{card}]", flush=True)
    for mode in PRODUCTION_MODES:
        for fast in (False, True):
            c = k1_issue(mode, fast)
            print(f"[3 K1 {mode}{' FAST' if fast else ''}] SASS "
                  f"lane-instructions an evaluation needs: {c['in']:.2f} "
                  f"inside |x| + y < 15, {c['out']:.2f} outside; Weideman "
                  f"{c['weideman_term']:.2f} a term", flush=True)
    check(set(stats) == {*PRODUCTION_MODES, *map(fk, PRODUCTION_MODES)},
          f"K1 sub-band exercised modes {sorted(stats)}")
    # the IEEE instantiations' launches on a user's path: the builder with
    # fast_rcp=False called on the sub-band (the main path runs FAST)
    reset_launches()
    od_ieee(base.T, base.p, base.pl, base.vmr)
    torch.cuda.synchronize()
    ieee = read_launches()
    check(all(ieee[m] > 0 and ieee[fk(m)] == 0 for m in PRODUCTION_MODES),
          f"3: make_od_fn(fast_rcp=False) launched {dict(ieee)}")
    print(f"[3 K1] make_od_fn(fast_rcp=False) on the sub-band: launches "
          f"{dict(ieee)}", flush=True)
    return finish_stats(stats), ieee


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


def t_tangents(od_fn, base, V,
               keys=("shift0", "strength", "gamma_d", "gamma_0")):
    """Line-parameter tangents of ``keys``, each (nd, nLay, L), of the T
    directions ``V`` (nd, nLay) at the state ``base``."""
    T, p, pl, vmr = base.T, base.p, base.pl, base.vmr

    def prm_of(T_):
        prm = od_fn.line_params(T_, p, pl, vmr)[0]
        return tuple(getattr(prm, k) for k in keys)

    return torch.func.vmap(
        lambda v: torch.func.jvp(prm_of, (T,), (v,))[1])(V)


def phase_k1_diff(dev, card):
    """3b: K1 'full' and K3, both instantiations, against their plain
    versions on every pass of the differentiable builder on the sub-band;
    returns their JSON fields and the IEEE instantiations' launches of a
    jvp of the builder with fast_rcp=False."""
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
    # each pass in the FAST instantiation (the builder's default) and the
    # IEEE one (fast_rcp=False)
    launches = []
    for lay, dplan, _ in od_fn.calls:
        args = (dplan, lay, prm.shift0, prm.strength, prm.gamma_d,
                prm.gamma_0, prm.wing)
        for fast in (True, False):
            launches.append(("K1 full", lambda args=args, fast=fast:
                             fused_xsect.xsect_fused(*args, None, "full",
                                                     N_WEI, fast=fast)))
            launches += [(f"K3 {name}", lambda args=args, tans=tans,
                          fast=fast: fused_xsect.xsect_fused_jvp(
                              *args, *tans, N_WEI, fast))
                         for name, tans in sets.items()]
    timed = iter(time_kernels(launches))
    stats, jvp_err, k3_dense = {}, {}, {}
    for call in od_fn.calls:
        lay, dplan, _ = call
        args = (dplan, lay, prm.shift0, prm.strength, prm.gamma_d,
                prm.gamma_0, prm.wing)
        outs = {}
        counts = window_counts(lay, dplan, prm)
        for fast in (True, False):
            # the plain versions of this instantiation's arithmetic
            p_ms, p_out = cuda_ms(lambda: fused_xsect.xsect_fused_plain(
                *args, None, "full", N_WEI, fast=fast), 1)
            own = p_out.abs().max().item()
            check(own > 0.0, "K1 full: the plain pass is zero on the band")
            plain_t = {name: cuda_ms(lambda tans=tans:
                                     fused_xsect.xsect_fused_jvp_plain(
                                         *args, *tans, N_WEI, fast), 1)
                       for name, tans in sets.items()}
            tag = " FAST" if fast else ""
            k_ms, k_out = next(timed)
            outs[fast, "full"] = k_out
            err = (k_out - p_out).abs().max().item()
            print(f"[3b K1 full{tag}] layers {lay.numel()} tile {dplan.tile} "
                  f"block {dplan.block} tiles {dplan.n_tiles}: "
                  f"max|kernel-plain| {err:.3e} = {err / own:.3e} of the "
                  f"pass's peak {own:.4e}; kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.3f} ms [{card}]", flush=True)
            check(err / own <= K1_OWN_BOUND["full"],
                        f"3b K1 full{tag}: {err / own:.3e} of peak > "
                        f"{K1_OWN_BOUND['full']}")
            key = fk("full") if fast else "full"
            add_stats(stats, key, err, k_ms, p_ms,
                      *k1_bound_work("full", lay, dplan, prm, counts),
                      instr=k1_issue_work("full", lay, dplan, prm, counts,
                                          fast))
            for name, tans in sets.items():
                k_ms, k_t = next(timed)
                outs[fast, name] = k_t
                tp_ms, p_t = plain_t[name]
                err = (k_t - p_t).abs().max().item()
                t_own = p_t.abs().max().item()
                # a pass none of whose layers the directions touch is zero
                touched = any(bool((t != 0).any(dim=0).any(dim=1)[
                    lay.long()].any()) for t in tans)
                check((t_own > 0.0) == touched, f"K3 {name}: the plain "
                      f"tangent is {'zero' if touched else 'non-zero'}")
                rel = err / t_own if touched else err
                print(f"[3b K3{tag} {name}] layers {lay.numel()}, "
                      f"{k_t.shape[0]} direction(s): max|kernel-plain| "
                      f"{err:.3e} = {rel:.3e} of the tangent's peak "
                      f"{t_own:.4e}; kernel {k_ms:.4f} ms, plain "
                      f"{tp_ms:.3f} ms [{card}]", flush=True)
                check(rel <= K3_BOUND if touched else err == 0.0,
                            f"3b K3{tag} {name}: {rel:.3e} of peak > "
                            f"{K3_BOUND}")
                jkey = fk("jvp") if fast else "jvp"
                jvp_err[jkey] = max(jvp_err.get(jkey, 0.0), err)
                if name.startswith("8"):
                    # the Jacobian's batch shape carries the times and bound
                    ops, nbytes, instr, dense = k3_bound_work(
                        lay, dplan, prm, tans, fast)
                    add_stats(stats, jkey, err, k_ms, tp_ms, ops, nbytes,
                              instr=instr)
                    k3_dense[jkey] = k3_dense.get(jkey, 0) + dense
        for what in ("full", *sets):
            peak = (own if what == "full"
                    else max(plain_t[what][1].abs().max().item(), 1e-30))
            fast_gap(f"3b {'K1' if what == 'full' else 'K3'} {what} layers "
                     f"{lay.numel()}", outs[True, what], outs[False, what],
                     peak, card)
    for jkey in ("jvp", fk("jvp")):
        stats[jkey]["max_abs_err"] = jvp_err[jkey]
        s = stats[jkey]
        c = k3_issue(jkey != "jvp")
        b_live = bound_str(s["ops"], s["bytes"])
        print(f"[3b K3 {jkey}] 8 one-hot T directions: bound ms {b_live} "
              "(live (pair, direction) products), "
              f"{bound(k3_dense[jkey], s['bytes'])[0]:.4f} charging each "
              "live pair all 8 directions; issue slots "
              "{bound_ms_issue:.4f} ({bound_ms_issue_measured:.4f} at the "
              "measured FMUL rate)".format(**issue_bounds(s["instr"],
                                                           s["bytes"]))
              + f"; SASS lane-instructions an evaluation needs: "
              f"{c['in']:.2f} inside |x| + y < 15, {c['out']:.2f} outside, "
              f"{c['dir']:.2f} a live direction [{card}]", flush=True)
    # the IEEE instantiations' launches on a user's path: one jvp of the
    # differentiable builder with fast_rcp=False on the sub-band
    od_ieee = make_od_fn(store, iso, X, base, continuum="mt_ckd",
                         differentiable=True, fast_rcp=False)
    reset_launches()
    torch.func.jvp(lambda T_: od_ieee(T_, p, pl, vmr), (T,),
                   (torch.linspace(0.5, 1.5, n_lay, device=dev),))
    torch.cuda.synchronize()
    ieee = read_launches()
    check(ieee["full"] > 0 and ieee["jvp"] > 0 and ieee[fk("full")] == 0
          and ieee[fk("jvp")] == 0,
          f"3b: the IEEE differentiable builder launched {dict(ieee)}")
    print(f"[3b] jvp of make_od_fn(differentiable=True, fast_rcp=False) on "
          f"the sub-band: launches {dict(ieee)}", flush=True)
    return finish_stats(stats), ieee


def xs_lines(dev):
    """The bench's synthetic list on ``dev``."""
    spec = {k: XS_BENCH[k] for k in ("n_lines", "nu_min", "nu_max", "seed",
                                     "sd_zero_frac")}
    return synthetic_lines(spec.pop("n_lines"), device=dev,
                           dtype=torch.float32, **spec)


def xs_states(dev):
    T = torch.as_tensor(XS_T, dtype=torch.float32, device=dev)
    return T, torch.ones_like(T)


@contextlib.contextmanager
def ieee_passes(fn):
    """``fn``'s passes in their IEEE instantiations (fast_rcp=False) while
    open: the plans do not depend on fast_rcp, so this is the builder
    called with fast_rcp=False."""
    was, fn.fast_rcp = fn.fast_rcp, False
    try:
        yield fn
    finally:
        fn.fast_rcp = was


def check_xs_passes(label, fn, prm, calls, card, stats=None, tag="3c",
                    both=False):
    """Each of ``calls`` (state indices, plan, mode) through its kernel at
    the builder's fast_rcp (all timed first; ``both``: and in the IEEE
    instantiation) and its plain version: within XS_BOUND of the lattice's
    peak and XS_OWN_BOUND of its own; the per-mode errors, times and bound
    work go into ``stats`` when given (FAST under ``fk(mode)``); ``tag``
    heads the printed lines."""
    peak = fn.line_sum(prm).abs().max().item()
    variants = (fn.fast_rcp, False) if both else (fn.fast_rcp,)
    launches = []
    for c in calls:
        for fast in variants:
            def run(c=c, fast=fast):
                if fast:
                    return fn.run_call(c, prm)
                with ieee_passes(fn):
                    return fn.run_call(c, prm)
            launches.append((f"K1 {c[2]}", run))
    timed = iter(time_kernels(launches))
    for call in calls:
        lay, dplan, mode = call
        outs = {}
        for fast in variants:
            # the plain version of this instantiation's arithmetic
            with contextlib.ExitStack() as ctx:
                if not fast:
                    ctx.enter_context(ieee_passes(fn))
                p_ms, p_out = cuda_ms(lambda: fn.run_call(
                    call, prm, kernel=fused_xsect.xsect_fused_plain), 1)
            # a window-edge band may hold no line on the sub-band: then
            # both are zero
            own = p_out.abs().max().item() or 1.0
            k_ms, k_out = next(timed)
            outs[fast] = k_out
            name = f"{mode}{' FAST' if fast else ''}"
            err = (k_out - p_out).abs().max().item()
            check(peak > 0.0 and bool(torch.isfinite(k_out).all()),
                  f"{label} {name}: zero lattice or non-finite pass")
            print(f"[{tag} {label}] {name} tile {dplan.tile} block "
                  f"{dplan.block} tiles {dplan.n_tiles} points {dplan.n_out}:"
                  f" max|kernel-plain| {err:.3e} = {err / peak:.3e} of the "
                  f"lattice's peak {peak:.4e} = {err / own:.3e} of the "
                  f"pass's own peak {own:.4e}; kernel {k_ms:.4f} ms, plain "
                  f"{p_ms:.3f} ms [{card}]", flush=True)
            check(err <= XS_BOUND * peak, f"{tag} {label} "
                        f"{name}: {err / peak:.3e} of the lattice's peak > "
                        f"{XS_BOUND}")
            check(err <= XS_OWN_BOUND[mode] * own, f"{tag} "
                        f"{label} {name}: {err / own:.3e} of its own peak > "
                        f"{XS_OWN_BOUND[mode]}")
            if stats is not None:
                add_stats(stats, fk(mode) if fast else mode, err, k_ms, p_ms,
                          *xs_bound_work(mode, lay, dplan, prm))
        if both:
            fast_gap(f"{tag} {label} {mode}", outs[True], outs[False], peak,
                     card)
        if fn.fast_rcp and mode in F64_MODES:
            xs_f64_reading(f"{tag} {label} {mode}", fn, call, prm, outs,
                           peak, card)


def xs_f64_reading(name, fn, call, prm, outs, peak, card):
    """One SD-Voigt pass of ``fn`` (FAST) against its plain version in
    float64 on the same line parameters, beside the IEEE instantiation and
    the float32 plain version (IEEE division), of the lattice's peak and
    of the pass's own float64 peak; FAST no further from the float64
    result than the float32 plain version is, plus XS_BOUND of the
    lattice's peak."""
    with ieee_passes(fn):
        if False not in outs:
            outs[False] = fn.run_call(call, prm)
        p_out = fn.run_call(call, prm, kernel=fused_xsect.xsect_fused_plain)
    ref = fn.run_call(call, params64(prm),
                      kernel=fused_xsect.xsect_fused_plain)
    own = ref.abs().max().item() or 1.0
    runs = {"FAST": outs[True], "IEEE": outs[False], "plain float32": p_out}
    gaps = f64_gaps(runs, ref, peak)
    print(f"[float64] {name}: against the plain version in float64, of the "
          "lattice's peak / of the pass's own peak: " + ", ".join(
              f"{k} {v:.3e} / {v * peak / own:.3e}" for k, v in gaps.items())
          + f" [{card}]", flush=True)
    limit = gaps["plain float32"] + XS_BOUND
    check(gaps["FAST"] <= limit, f"{name} FAST vs float64: "
          f"{gaps['FAST']:.3e} of the lattice's peak > the float32 "
          f"plain version's + {XS_BOUND} = {limit:.3e}")


def phase_xs_sub(dev, card):
    """3c: every pass of the lattice builders on the 1000-1010 cm^-1
    sub-band, the timed ones in both instantiations; returns the new modes'
    JSON fields (both), the launches of the direct corr:64:*full runs
    (FAST) and the IEEE instantiations' launches (the builders with
    fast_rcp=False, and the direct *full runs)."""
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
                        stats if label in timed else None,
                        both=label in timed)
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
    # the IEEE instantiations' launches on a user's path: the builders
    # called with fast_rcp=False on the sub-band, and the direct '*full'
    # runs (the main path runs FAST)
    reset_launches()
    for kw in (dict(profile="sdvoigt"), dict(profile="sdvoigt",
                                             two_pass=False),
               dict(profile="lorentz"), dict(profile="doppler")):
        build(fast_rcp=False, **kw)(T, p)
    with ieee_passes(main):
        for c in full_calls:
            main.run_call(c, prm)
    torch.cuda.synchronize()
    ieee = read_launches()
    check(all(ieee[m] > 0 and ieee[fk(m)] == 0 for m in XS_MODES),
          f"3c: the IEEE lattices launched {dict(ieee)}")
    print(f"[3c] make_xsect_fn(fast_rcp=False) lattices and the direct "
          f"*full runs on the sub-band: launches {dict(ieee)}", flush=True)
    return (finish_stats({m: stats[m] for m in
                          (*XS_MODES, *map(fk, XS_MODES))}),
            full_launches, ieee)


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
    out["tud_jvp"] = phase_k2_jvp(args, gen, card)
    return out


def phase_k2_jvp(args, gen, card):
    """K2's tangent mode at the Jacobian cell's shape: K2_JVP_DIRS dense
    directions (OD tangents a twentieth of the OD, temperature tangents of
    1 K) in one launch, against its plain version."""
    od, x, inv_t, mus, snap, sec, w = args
    n_l, n_x = od.shape
    n_d, n_zs, n_mu, n_a = K2_JVP_DIRS, snap.numel(), mus.numel(), sec.numel()
    dod = 0.05 * od * torch.randn((n_d, n_l, n_x), generator=gen,
                                  device=od.device)
    dT = torch.randn((n_d, n_l), generator=gen, device=od.device)
    jargs = (*args, dod, dT)

    def kern():
        return fused_tud.tud_compose_jvp(*jargs)

    reset_launches()
    kern()
    out = {"launches": read_launches()["tud_jvp"]}
    check(out["launches"] == 1, f"K2 tangent: {out['launches']} launches "
          "for one batch")
    k_ms, got = cuda_ms(kern, 5)
    again = kern()
    check(all(torch.equal(a, b) for a, b in zip(got, again)),
          "K2 tangent: two launches on the same inputs differ")
    del again
    p_ms, want = cuda_ms(lambda: fused_tud.tud_compose_jvp_plain(*jargs), 1)
    err_max = 0.0
    for prod, g, r in zip(("dtau", "dLu", "dLd"), got, want):
        rel = max(((g[d] - r[d]).abs().max() / r[d].abs().max()).item()
                  for d in range(n_d))
        err_max = max(err_max, (g - r).abs().max().item())
        print(f"[4 K2 tangent {prod}] shape {tuple(g.shape)}: "
              f"max|kernel-plain| {rel:.3e} of the worst direction's own "
              "peak", flush=True)
        check(rel <= K2_JVP_BOUND, f"K2 tangent {prod}: {rel:.3e} > "
              f"{K2_JVP_BOUND}")
    del want
    # the needed work: per column and layer one exp2 per downwelling angle
    # (its transmittance to the ground) and per secant (the layer's), the
    # source's expm1 and divide once, an expf a snapshot; FP32 operations
    # (one an instruction, as K2's): the source and its slope ~33, 6 a
    # downwelling angle (the sensitivities' sums), 3 a secant, 7 a
    # direction (dB, dLu, dcum, dLd); bytes: od and dod read once, the
    # tangents written once (the primal is K2's launch)
    sfu = n_x * (n_l * (n_mu + n_a + 2) + n_zs * n_mu)
    ops = n_x * n_l * (33 + 6 * n_a + 3 * n_mu + 7 * n_d)
    nbytes = 4 * n_x * ((1 + n_d) * n_l + n_d * (2 * n_zs * n_mu + 1))
    stats = {}
    add_stats(stats, "tud_jvp", err_max, k_ms, p_ms, ops, nbytes, sfu)
    out.update(finish_stats(stats)["tud_jvp"])
    print(f"[4 K2 tangent] {n_x} points x {n_l} layers, {n_zs} altitudes, "
          f"{n_a} angles, {n_d} directions in one launch: kernel "
          f"{k_ms:.4f} ms ({k_ms / n_d:.4f} ms a direction), plain "
          f"{p_ms:.3f} ms; bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}: {sfu:.4g} special-function ops at "
          f"{SFU_OPS_PER_S:.4g}/s, {ops:.4g} lane-ops at "
          f"{FP32_OPS_PER_S:.4g}/s, {nbytes:.4g} B at {HBM_BYTES_PER_S:.4g}"
          f" B/s) [{card}]", flush=True)
    return out


# phase 5e: the scene path. The card's float32 against the CPU's float64:
# of the peak (MAKO) or relative (radiance, HSI); the card's float32 NMF
# core against the CPU's float64 from the same factors (the same run in
# float32 on a CPU measured 8.9e-7 of the reconstruction's peak); the
# variational fit in float64 on both (its near-empty components' means move
# by 2.7e-7 under a 1e-15 input change, so the check holds the weights and
# the data's log-density, which those means do not move)
SCENE_BOUND = 1e-6
NMF_BOUND = 1e-5
BGMM_WEIGHT_BOUND = 1e-8
BGMM_LOGP_BOUND = 1e-8
# ``planck``'s float32 brightness-temperature round trip [K] (3.1e-5 K on
# its 2,880 points in float32 on a CPU)
PLANCK_BT_BOUND = 1e-3
SCENE_ATMOS = 1000       # the MAKO products tiled to the reference's count
HSI_SCENE = 10_000       # a 100 x 100 scene
HSI_CHECK_PIXELS = 200   # its pixels per atmosphere re-composed on the CPU


def reset_launches():
    fused_xsect.LAUNCHES.clear()
    for k in fused_tud.LAUNCHES:
        fused_tud.LAUNCHES[k] = 0


def read_launches():
    """The launches since the last reset, per kernel (0 for any not run)."""
    return collections.Counter(fused_xsect.LAUNCHES, **fused_tud.LAUNCHES)


#: launch keys of kernels without a FAST instantiation: K2 (its three
#: modes), K6 (JAX's tangent kernel forces fast=False) and the probe
NO_FAST = ("tud", "tud_b", "tud_jvp", "ht_jvp", "fp32_peak_probe")


def fast_path(launches, where):
    """A path's launch counts (or tile-offset launch counts) keyed by
    kernel, each FAST instantiation's under its kernel's key: the path runs
    the builders at their default, JAX's fast_rcp=True, so it fails if an
    IEEE instantiation of a kernel that has a FAST one was launched (nothing
    falls back to it)."""
    suffix = fk("")
    ieee = {k: v for k, v in launches.items()
            if v and not k.endswith(suffix) and k not in NO_FAST}
    check(not ieee, f"{where}: IEEE instantiations launched on a "
          f"fast_rcp=True path: {ieee}")
    return collections.Counter({k[:-len(suffix)] if k.endswith(suffix)
                                else k: v for k, v in launches.items()})


def phase_main(card):
    args = build_parser().parse_args(PRODUCTION.split())
    timings = {}
    reset_launches()
    x_lo, out = run_tud(args, "cuda", timings)
    launches = fast_path(read_launches(), "5 main")
    print(f"[5 main] launches during run_tud (every K1 launch in its FAST "
          f"instantiation): {dict(launches)}", flush=True)
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
        check(rel <= SLICE_BOUND, f"slice {k}: {rel:.3e} > "
              f"{SLICE_BOUND}")
    return launches, x_lo, out


def scene_args(cmd):
    return build_parser().parse_args(cmd.split())


def warm_s(fn):
    """(seconds, result) of a second call of ``fn`` (the first warms it),
    on the host clock; the scene commands return host arrays, so each
    call ends synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def rel_err(got, want):
    """The largest |got - want| / |want| over the elements."""
    return float(np.max(np.abs(np.asarray(got, np.float64) - want)
                        / np.abs(want)))


def check_hsi(label, args, out, data, n_db, card):
    """The HSI cube's invariants and its re-composition from the card's
    own labels, fractions and temperatures on the CPU in float64 (the
    first ``HSI_CHECK_PIXELS`` pixels of each atmosphere)."""
    n_atm = min(args.n_atm, data["tau"].shape[0])
    n_x = data["X"].size
    L = out["L"]
    check(L.shape == (n_atm, args.n_pixels, n_x), f"{label}: L {L.shape}")
    check(np.isfinite(L).all() and (L > 0).all(), f"{label}: L not finite")
    check(np.abs(out["mix_frac"].sum(axis=2) - 1.0).max() <= 1e-6,
          f"{label}: fractions do not sum to 1")
    check(out["emis_labels"].min() >= 0 and out["emis_labels"].max() < n_db
          and out["atmos_labels"].min() >= 0
          and out["atmos_labels"].max() < data["tau"].shape[0],
          f"{label}: labels out of range")
    p = slice(0, HSI_CHECK_PIXELS)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    top = lambda a: a[:, :, -1] if a.ndim == 3 else a         # noqa: E731
    emis = synthetic_db(args.n_materials, X=data["X"], seed=args.seed,
                        device="cpu").emis
    ref = _hsi_compose(t(data["X"]), t(top(data["tau"])), t(top(data["La"])),
                       t(data["Ld"]), emis,
                       torch.as_tensor(out["atmos_labels"]),
                       torch.as_tensor(out["emis_labels"][:, p]),
                       t(out["mix_frac"][:, p]), t(out["Ts_pix"][:, p]))
    err = rel_err(L[:, p], ref.numpy())
    print(f"[5e scene] {label}: L {L.shape} in [{L.min():.4g}, "
          f"{L.max():.4g}]; the card's draws re-composed on the CPU in "
          f"float64: {err:.3e} relative [{card}]", flush=True)
    check(err <= SCENE_BOUND, f"{label}: {err:.3e} > {SCENE_BOUND}")


def phase_scene(card, launches, x_lo, products):
    """Phase 5e: ``tud`` -> ``mako`` -> ``radiance`` -> ``hsi`` on phase
    5's products, then ``emis`` and ``atmosgen``; returns each command's
    seconds."""
    n = products["tau"].shape[0]
    print(f"[5e scene] the feeding tud ({n} members, {x_lo.size} points at "
          f"{x_lo[1] - x_lo[0]:.4g} cm^-1): K1 asym {launches['asym']}, "
          f"core {launches['core']}, mix {launches['mix']}, K2 "
          f"{launches['tud']} launches", flush=True)
    reset_launches()
    data = {"X": x_lo, "tau": products["tau"], "La": products["Lu"],
            "Ld": products["Ld"]}
    secs = {}

    p = scene_args("planck")
    secs["planck"], pl = warm_s(lambda: run_planck(p, "cuda"))
    ref = run_planck(p, "cpu")
    err = np.abs(pl["B"] - ref["B"]).max() / np.abs(ref["B"]).max()
    print(f"[5e scene] planck: {pl['B'].size} points at T0 {pl['T0']:.2f} "
          f"K, card float32 vs CPU float64 {err:.3e} of peak, BT round trip "
          f"{pl['bt_err']:.3e} K", flush=True)
    check(pl["B"].shape == ref["B"].shape and err <= SCENE_BOUND
          and pl["bt_err"] <= PLANCK_BT_BOUND,
          f"planck: {err:.3e} of peak, round trip {pl['bt_err']:.3e} K")

    a = scene_args("mako --input -")
    secs["mako"], mk = warm_s(lambda: run_mako(a, "cuda", data))
    ref = run_mako(a, "cpu", data)
    check(mk["X"].size == ref["X"].size == mako_axis_wn(x_lo).size >= 2,
          "MAKO channels")
    for k in ("tau", "La", "Ld"):
        check(mk[k].shape == (n, mk["X"].size) and np.isfinite(mk[k]).all(),
              f"MAKO {k} shape or values")
        err = np.abs(mk[k] - ref[k]).max() / np.abs(ref[k]).max()
        print(f"[5e scene] mako {k}: {mk['X'].size} channels, card vs CPU "
              f"float64 {err:.3e} of peak", flush=True)
        check(err <= SCENE_BOUND, f"MAKO {k}: {err:.3e} > {SCENE_BOUND}")

    r = scene_args("radiance --input -")
    n_t = np.arange(-10.0, 10.0 + r.dT_step, r.dT_step).size
    mako_data = {"X": mk["X"], **{k: np.tile(mk[k], (SCENE_ATMOS // n, 1))
                                  for k in ("tau", "La", "Ld")}}
    for label, d in (("radiance", data), ("radiance_mako1000", mako_data)):
        secs[label], rad = warm_s(lambda: run_radiance(r, "cuda", d))
        L = rad["L"]
        n_a = d["tau"].shape[0]
        check(L.shape == (d["X"].size, r.n_materials, n_a, n_t)
              and L.dtype == np.float32, f"{label}: L {L.shape} {L.dtype}")
        check(np.isfinite(L).all() and L.min() > 0.0, f"{label}: L <= 0")
        k = 1 if n_a == n else 2
        ref = run_radiance(r, "cpu", {"X": d["X"], **{
            q: d[q][:k] for q in ("tau", "La", "Ld")}})["L"]
        err = rel_err(L[:, :, :k], ref)
        print(f"[5e scene] {label}: L {L.shape} ({L.nbytes / 2**20:.1f} MiB "
              f"float32) in [{L.min():.4g}, {L.max():.4g}]; card vs CPU "
              f"float64 on {k} atmosphere(s) {err:.3e} relative", flush=True)
        check(err <= SCENE_BOUND, f"{label}: {err:.3e} > {SCENE_BOUND}")

    for label, cmd in (("hsi", "hsi --input -"),
                       ("hsi_100x100",
                        f"hsi --input - --n-pixels {HSI_SCENE}")):
        h = scene_args(cmd)
        secs[label], hs = warm_s(lambda: run_hsi(h, "cuda", data))
        check_hsi(label, h, hs, data, h.n_materials, card)

    e = scene_args("emis --mixtures --mako --features 16")
    secs["emis"], em = warm_s(lambda: run_emis(e, "cuda"))
    db = em["db"]
    n_mix = 24 * 23 // 2 * e.n_fractions         # every pair, each fraction
    check(db.n_materials == n_mix and em["db_mako"].emis.shape == (n_mix, 128)
          and em["k"] == 16 and em["nmf_shape"] == (16, db.X.numel()),
          "emis: DB, MAKO DB or feature shapes")
    check(np.isfinite([em["err_pca"], em["err_spl"]]).all(),
          "emis: feature errors not finite")
    od = od_transform(db.emis.float())
    rng = np.random.default_rng(0)
    scale = float(torch.sqrt(od.mean() / 16))
    W0 = scale * np.abs(rng.standard_normal((od.shape[0], 16)))
    H0 = scale * np.abs(rng.standard_normal((16, od.shape[1])))
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32,  # noqa: E731
                                    device="cuda")
    loops = {}
    loops["nmf 400 (3036 x 721, k 16, float32)"], got = warm_s(
        lambda: _nmf(od, f32(W0), f32(H0)))
    loops["fast_ica 200 (3036 x 721, k 16, float32)"], _ = warm_s(
        lambda: _fast_ica(od, f32(rng.standard_normal((16, 16)))))
    ref = _nmf(od.double().cpu(), torch.as_tensor(W0), torch.as_tensor(H0))
    R = (ref.W @ ref.H).numpy()
    err = np.abs((got.W @ got.H).double().cpu().numpy() - R).max() / \
        np.abs(R).max()
    print(f"[5e scene] emis: {db.n_materials} entries x {db.X.numel()} "
          f"points, MAKO DB {tuple(em['db_mako'].emis.shape)}, PCA max err "
          f"{em['err_pca']:.3e}, B-spline {em['err_spl']:.3e}; NMF core "
          f"(400 updates, k 16) card float32 vs CPU float64 {err:.3e} of "
          "the reconstruction's peak", flush=True)
    check(err <= NMF_BOUND, f"NMF core: {err:.3e} > {NMF_BOUND}")

    for label, cmd in (("atmosgen", "atmosgen"),
                       ("atmosgen_1000", "atmosgen --n-ensemble 1000")):
        g = scene_args(cmd)
        secs[label], ag = warm_s(lambda: run_atmosgen(g, "cuda"))
        n_in, n_gen = ag["T_in"].shape[0], ag["T"].shape[0]
        ok = rh_filter(torch.as_tensor(ag["P"]), torch.as_tensor(ag["T"]),
                       torch.as_tensor(ag["H2O"]))
        check(0 < n_gen <= g.n_aug * n_in and ag["T"].shape == (n_gen, 66)
              and ag["H2O"].shape == ag["O3"].shape == (n_gen, 66),
              f"{label}: counts or shapes")
        check((ag["T"] > 0).all() and bool(ok.all())
              and np.isfinite(ag["loglik"]).all()
              and ag["airmass"].min() >= 0
              and ag["airmass"].max() < ag["n_air"],
              f"{label}: T <= 0, a supersaturated layer or bad labels")
        print(f"[5e scene] {label}: {n_in} -> {n_gen} profiles, "
              f"{len(np.unique(ag['airmass']))} air masses; T in "
              f"[{ag['T'].min():.2f}, {ag['T'].max():.2f}] K", flush=True)
    scene_launches = +read_launches()
    print(f"[5e scene] kernel launches of the six scene commands: "
          f"{dict(scene_launches)}", flush=True)
    check(not scene_launches, "the scene commands launched a kernel")
    t = std_atmosphere_raw()
    T, H2O, O3 = atmosgen_ensemble(1000, 0)
    feats = [_airmass_features(*(torch.as_tensor(v, device=d)
                                 for v in (t[:, 1], t[:, 4], T, H2O, O3)))
             for d in ("cuda", "cpu")]
    k0 = torch.as_tensor(np.random.default_rng(0).permutation(1000)[:5])
    fits = [_bgmm_fit(f, k0.to(f.device), n_iter=300) for f in feats]
    k0c = k0.to("cuda")
    loops["bgmm 500 (1000 x 4, K 5, float64)"], _ = warm_s(
        lambda: _bgmm_fit(feats[0], k0c, n_iter=500))
    loops["gmm 200 (1000 x 4, K 5, float64)"], _ = warm_s(
        lambda: _gmm_fit(feats[0], k0c, n_iter=200))
    w = [m.weights.cpu().numpy() for m in fits]
    lp = [gmm_log_prob(m, f).cpu().numpy() for m, f in zip(fits, feats)]
    w_err = np.abs(w[0] - w[1]).max() / np.abs(w[1]).max()
    # of the peak: a row's log-density can lie near zero
    lp_err = np.abs(lp[0] - lp[1]).max() / np.abs(lp[1]).max()
    print(f"[5e scene] variational fit core (1000 members, 5 components, "
          f"300 steps, float64) card vs CPU: weights {w_err:.3e} and "
          f"log-density {lp_err:.3e} of peak", flush=True)
    check(w_err <= BGMM_WEIGHT_BOUND and lp_err <= BGMM_LOGP_BOUND,
          f"variational fit core: {w_err:.3e}, {lp_err:.3e}")
    print(f"[5e scene] fixed-count loops on the card (seconds, warm, "
          "host clock): " + ", ".join(f"{k} {v:.4f}"
                                      for k, v in loops.items())
          + f" [{card}]", flush=True)
    print(f"[5e scene] seconds (warm, host clock): " + ", ".join(
        f"{k} {v:.4f}" for k, v in secs.items()) + f" [{card}]", flush=True)
    scene_chain(card)
    return secs


class RecordingH5:
    """A stand-in for ``h5py`` where it is not installed (the card's
    machine): ``File(name, "w")`` records each dataset's array and
    attributes under ``name``, so ``write_h5``'s host copies can be held
    bit for bit (real files' bytes are held on the CPU,
    ``tests/test_torch_faults_q3.py``)."""

    def __init__(self):
        self.files = {}

    def File(self, name, mode):  # noqa: N802 (h5py's name)
        rec = self.files.setdefault(name, {"": types.SimpleNamespace(
            data=None, attrs={})})

        def create_dataset(key, data):
            rec[key] = types.SimpleNamespace(data=data, attrs={})
            return rec[key]

        return contextlib.nullcontext(types.SimpleNamespace(
            attrs=rec[""].attrs, create_dataset=create_dataset))


H5_ATTRS = ("units", "name", "info", "label")


def recorded_h5(path, variables):
    """{dataset: (array, (units, name, info, label))} of ``write_h5(path,
    variables)``: read back with h5py, or recorded by :class:`RecordingH5`
    where h5py is absent (also ``tests/test_torch_cuda.py``'s)."""
    try:
        import h5py  # noqa: F401
    except ImportError:
        pass
    else:
        write_h5(path, variables)
        return {k: (v.data, tuple(getattr(v, a) for a in H5_ATTRS))
                for k, v in read_h5(path).items()}
    stand_in, saved = RecordingH5(), sys.modules.get("h5py")
    sys.modules["h5py"] = stand_in
    try:
        write_h5(path, variables)
    finally:
        sys.modules.pop("h5py")
        if saved is not None:
            sys.modules["h5py"] = saved
    return {k: (n.data, tuple(str(n.attrs.get(a, "")) for a in H5_ATTRS))
            for k, n in stand_in.files[path].items() if k}


def same_bits(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape and \
        a.tobytes() == b.tobytes()


def scene_chain(card):
    """Phase 5e's chain: one production member at full width on the card,
    its products passed on as card tensors through ``make_tud_fn`` ->
    ``ils_mako`` -> ``reduce_operator`` -> ``write_h5`` ->
    ``EnsembleCheckpoint.write_batch``, each step against the same call on
    host copies (bit for bit)."""
    f32, dev = torch.float32, torch.device("cuda")
    store = derived_lwir_linelist(FULL_BAND[0] - MARGIN, FULL_BAND[1] + MARGIN,
                                  device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    X = arange_drift_free(*FULL_BAND)
    secs = {}
    reset_launches()
    t0 = time.perf_counter()
    od_fn = make_od_fn(store, IsoTables.load(device=dev, dtype=f32), X, base,
                       continuum="mt_ckd",
                       line_mixing={"y_air": y_air_for_store(store)})
    od = od_fn(base.T, base.p, base.pl, base.vmr)
    x = torch.as_tensor(X, dtype=f32, device=dev)
    alts = torch.as_tensor(ALTITUDES, device=dev)
    t = make_tud_fn(base.z0, alts, device=dev)(x, od, base.T)
    torch.cuda.synchronize()
    secs["member (plan, od, tud)"] = time.perf_counter() - t0
    launches = fast_path(read_launches(), "5e chain")
    for k in (*PRODUCTION_MODES, "tud"):
        check(launches[k] > 0, f"chain: kernel {k} was not launched")
    t_h = make_tud_fn(base.z0.cpu().numpy(), ALTITUDES, device=dev)(
        x, od, base.T)
    for k in ("X", "tau", "Lu", "Ld"):
        check(getattr(t, k).is_cuda and torch.equal(getattr(t, k),
                                                    getattr(t_h, k)),
              f"chain: make_tud_fn on card z0/altitudes, {k} differs")
    host_x = t.X.cpu().numpy()
    t0 = time.perf_counter()
    mx, my = ils_mako(t.X, t.tau)
    torch.cuda.synchronize()
    secs["ils_mako"] = time.perf_counter() - t0
    hx, hy = ils_mako(host_x, t.tau)
    check(my.is_cuda and np.array_equal(mx, hx) and torch.equal(my, hy),
          "chain: ils_mako on t.X differs from the host copy's")
    t0 = time.perf_counter()
    op = reduce_operator(t.X, 0.25)
    red = [op(a) for a in (t.tau, t.Lu, t.Ld)]
    torch.cuda.synchronize()
    secs["reduce_operator"] = time.perf_counter() - t0
    op_h = reduce_operator(host_x, 0.25)
    check(np.array_equal(op.x_out, op_h.x_out)
          and all(r.is_cuda and torch.equal(r, op_h(a))
                  for r, a in zip(red, (t.tau, t.Lu, t.Ld))),
          "chain: reduce_operator on t.X differs from the host copy's")
    work = tempfile.mkdtemp(prefix="chip_smoke_chain_")
    card_vars = {"X": Var(torch.as_tensor(op.x_out), units="cm^{-1}"),
                 "tau": Var(red[0], units="none"), "La": red[1],
                 "Ld": red[2], "mako_tau": my}
    host_vars = {k: (Var(v.data.cpu().numpy(), units=v.units)
                     if isinstance(v, Var) else v.cpu().numpy())
                 for k, v in card_vars.items()}
    t0 = time.perf_counter()
    got = recorded_h5(os.path.join(work, "card.h5"), card_vars)
    secs["write_h5"] = time.perf_counter() - t0
    want = recorded_h5(os.path.join(work, "host.h5"), host_vars)
    check(set(got) == set(want) == set(card_vars)
          and all(same_bits(got[k][0], want[k][0]) and got[k][1] == want[k][1]
                  for k in got), "chain: write_h5 of card tensors differs")
    arrays = {"tau": red[0], "La": red[1], "Ld": red[2]}
    t0 = time.perf_counter()
    EnsembleCheckpoint(os.path.join(work, "card"), 1, 1).write_batch(
        0, arrays)
    secs["write_batch"] = time.perf_counter() - t0
    EnsembleCheckpoint(os.path.join(work, "host"), 1, 1).write_batch(
        0, {k: v.cpu().numpy() for k, v in arrays.items()})
    got, want = (EnsembleCheckpoint(os.path.join(work, n), 1, 1)
                 .read_batch(0) for n in ("card", "host"))
    check(all(same_bits(got[k], want[k]) for k in arrays),
          "chain: write_batch of card tensors differs")
    shutil.rmtree(work)
    print(f"[5e chain] one production member ({X.size} points, 66 layers, "
          f"{len(ALTITUDES)} altitudes; launches "
          f"{ {k: v for k, v in launches.items() if v} }) -> make_tud_fn(card "
          f"z0, card altitudes) -> ils_mako(t.X, t.tau) ({mx.size} "
          f"channels) -> reduce_operator(t.X, 0.25) ({op.x_out.size} "
          f"points) -> write_h5 (h5py "
          f"{'present' if 'h5py' in sys.modules else 'absent: recorded'}) "
          f"-> write_batch: every step on card tensors, bit-identical to "
          f"the host copies' route", flush=True)
    print("[5e chain] seconds (host clock, first calls): " + ", ".join(
        f"{k} {v:.4f}" for k, v in secs.items())
        + f"; chain total {sum(secs.values()):.4f} [{card}]", flush=True)
    t0 = time.perf_counter()
    numpy_member(card, base, od_fn, od, x, t, op)
    e2e_on_card(card)
    print(f"[5e numpy] the NumPy-input checks took "
          f"{time.perf_counter() - t0:.2f} s (host clock) [{card}]",
          flush=True)


def numpy_member(card, base, od_fn, od, x, t, op):
    """The chain's production member from host NumPy inputs: ``base``'s
    columns into ``od_fn``, the axis into ``make_tud_fn``'s function and
    ``tud_from_od``, tau/Lu/Ld into the reduction operator and
    ``reduce_resolution``. Each result on the card and bit-identical to
    the same call on the card tensors."""
    dev = torch.device("cuda")
    host = lambda a: a.cpu().numpy()  # noqa: E731
    secs, same = {}, {}

    def timed(name, fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return out

    on_card = lambda *a: all(v.is_cuda for v in a)  # noqa: E731
    od_np = timed("od_fn", lambda: od_fn(*(host(getattr(base, f)) for f in
                                           ("T", "p", "pl", "vmr"))))
    same["od_fn"] = on_card(od_np) and torch.equal(od_np, od)
    tud_fn = make_tud_fn(base.z0, torch.as_tensor(ALTITUDES, device=dev),
                         device=dev)
    t_np = timed("make_tud_fn", lambda: tud_fn(host(x), od, host(base.T)))
    same["make_tud_fn"] = all(
        on_card(getattr(t_np, k)) and torch.equal(getattr(t_np, k),
                                                  getattr(t, k))
        for k in ("X", "tau", "Lu", "Ld"))
    # tud_from_od on the tensor route and on the host axis (float32, the
    # card tensor's copy), the reference engine's composition
    B = planckian(x, base.T).transpose(0, 1).to(od.dtype)
    alts = torch.as_tensor(ALTITUDES, dtype=od.dtype, device=dev)
    ref = tud_from_od(x, od, B, base.z0, alts, n_angles=30)
    got = timed("tud_from_od", lambda: tud_from_od(host(x), od, B, base.z0,
                                                   alts, n_angles=30))
    same["tud_from_od"] = all(
        on_card(getattr(got, k)) and torch.equal(getattr(got, k),
                                                 getattr(ref, k))
        for k in ("X", "tau", "Lu", "Ld"))
    prods = (t.tau, t.Lu, t.Ld)
    red = timed("reduce_operator", lambda: [op(host(a)) for a in prods])
    same["reduce_operator"] = all(
        on_card(r) and torch.equal(r, op(a)) for r, a in zip(red, prods))
    x64 = host(x).astype(np.float64)
    rr = timed("reduce_resolution",
               lambda: [reduce_resolution(x64, host(a), 0.25)[1]
                        for a in prods])
    same["reduce_resolution"] = all(
        on_card(r) and torch.equal(r, reduce_resolution(x64, a, 0.25)[1])
        for r, a in zip(rr, prods))
    for k, ok in same.items():
        check(ok, f"numpy member: {k} on NumPy inputs is not on the card or "
                  "differs from the tensor route")
    print(f"[5e numpy] one production member from host NumPy inputs "
          f"({x.numel()} points, 66 layers): od_fn(base's columns), "
          f"make_tud_fn(...)(X, od, T) and tud_from_od(X, ...), "
          f"reduce_operator(tau/Lu/Ld) and reduce_resolution(X, tau/Lu/Ld): "
          f"each on the card and bit-identical to the tensor route "
          f"({ {k: bool(v) for k, v in same.items()} }); seconds (host "
          f"clock): " + ", ".join(f"{k} {v:.4f}" for k, v in secs.items())
          + f" [{card}]", flush=True)


def e2e_on_card(card):
    """``tools/e2e_drive.py``'s steps at its own size (2000 synthetic
    lines, 690-1410 cm^-1 at 0.05, the 66-layer standard atmosphere) on
    the card through the port (``radtxfr_tpu_torch/tools/e2e_drive.py``),
    the layer OD on the K1 route, its NumPy hand-offs kept."""
    reset_launches()
    t0 = time.perf_counter()
    try:
        out = e2e_drive.drive("cuda", dtype=torch.float32, engine="pallas",
                              **e2e_drive.FULL)
    except (AssertionError, ValueError, RuntimeError) as e:
        check(False, f"e2e drive on the card: {type(e).__name__}: {e}")
        return
    secs = time.perf_counter() - t0
    launches = {k: v for k, v in read_launches().items() if v}
    check(sum(fused_xsect.LAUNCHES.values()) > 0,
          "e2e drive: compute_od_layers(engine='pallas') launched no K1 pass")
    check(np.isfinite(out["tau"]).all() and out["tau"].shape ==
          (out["grid"].size, 4, 1), "e2e drive: tau is not finite or shaped")
    print(f"[5e e2e] tools/e2e_drive.py's steps on the card: "
          f"{out['grid'].size} points, 2000 lines, 66 layers, K1 launches "
          f"{launches}; steps (s) "
          + ", ".join(f"{k} {v:.3f}" for k, v in out["seconds"].items())
          + f"; skipped {out['skipped']}; probe: {out['probe_error']}; "
          f"total {secs:.2f} s [{card}]", flush=True)


#: a child of phase 5c: the production command through run_tud on the
#: card, its own launch counts, each batch file's write timed and, with
#: ``kill``, SIGKILL right after the first is in place; the products
#: streamed to ``<out>.bin`` with np.save (and ``<out>.h5`` where h5py is
#: installed), the counts and times to ``<out>.json``
CHECKPOINT_CHILD = """
import collections, json, os, signal, sys, time
sys.path.insert(0, {root!r})
import numpy as np
from radtxfr_tpu_torch.cli.main import _write_tud_h5, build_parser, run_tud
from radtxfr_tpu_torch.dist.checkpoint import EnsembleCheckpoint
from radtxfr_tpu_torch.kernels import fused_tud, fused_xsect
write, writes = EnsembleCheckpoint.write_batch, []
def timed_write(self, b, arrays):
    t0 = time.perf_counter()
    write(self, b, arrays)
    writes.append(time.perf_counter() - t0)
    if {kill!r}:
        os.kill(os.getpid(), signal.SIGKILL)
EnsembleCheckpoint.write_batch = timed_write
fused_xsect.LAUNCHES.clear()
for k in fused_tud.LAUNCHES:
    fused_tud.LAUNCHES[k] = 0
args = build_parser().parse_args({argv!r})
timings = {{}}
x_lo, out = run_tud(args, "cuda", timings)
launches = collections.Counter(fused_xsect.LAUNCHES, **fused_tud.LAUNCHES)
with open({out!r} + ".bin", "wb") as f:
    for a in (x_lo, out["tau"], out["Lu"], out["Ld"]):
        np.save(f, np.ascontiguousarray(a))
try:
    import h5py  # noqa: F401
    _write_tud_h5({out!r} + ".h5", x_lo, out, args.altitudes)
except ImportError:
    pass
with open({out!r} + ".json", "w") as f:
    json.dump(dict(launches=launches, timings=timings, writes=writes), f)
"""


def checkpoint_child(argv, out, kill=False):
    """Run one phase-5c child; its exit code and output."""
    code = CHECKPOINT_CHILD.format(
        root=os.path.dirname(os.path.abspath(__file__)), argv=argv, out=out,
        kill=kill)
    run = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=CHILD_TIMEOUT)
    return run.returncode, run.stdout + run.stderr


def read_products(path):
    with open(path, "rb") as f:
        return [np.load(f) for _ in range(4)]


def phase_checkpoint(card):
    """The production command with --checkpoint, killed after its first
    batch and resumed, against an uninterrupted run and a run without
    checkpoints."""
    work = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    base = CHECKPOINTED.split()
    t0 = time.perf_counter()
    a = os.path.join(work, "a")
    rc, log = checkpoint_child(base + ["--checkpoint",
                                       os.path.join(work, "ck_a")], a)
    check(rc == 0, f"uninterrupted checkpointed run failed ({rc}):\n"
          f"{log[-3000:]}")
    t1 = time.perf_counter()
    b, ck_b = os.path.join(work, "b"), os.path.join(work, "ck_b")
    argv = base + ["--checkpoint", ck_b]
    rc, log = checkpoint_child(argv, b, kill=True)
    check(rc == -9, f"the killed child ended with {rc}, not SIGKILL:\n"
          f"{log[-3000:]}")
    listing = sorted(f for f in os.listdir(ck_b))
    check(listing == ["batch_000000.npz", "manifest.json"],
          f"before the resume the checkpoint held {listing}")
    check(not any(os.path.exists(b + ext) for ext in (".bin", ".h5")),
          "the killed run wrote its output")
    t2 = time.perf_counter()
    rc, log = checkpoint_child(argv, b)
    check(rc == 0, f"the resumed run failed ({rc}):\n{log[-3000:]}")
    check("batch 1/3" not in log and "batch 3/3" in log,
          "the resumed run recomputed the first batch")
    t3 = time.perf_counter()
    for ext in (".bin", ".h5"):
        if os.path.exists(a + ext) or os.path.exists(b + ext):
            with open(a + ext, "rb") as f, open(b + ext, "rb") as g:
                check(f.read() == g.read(), f"a{ext} and b{ext} differ")
    have_h5 = os.path.exists(a + ".h5")
    args = build_parser().parse_args(base)
    plain_t = {}
    x_lo, out = run_tud(args, "cuda", plain_t)
    got = read_products(b + ".bin")
    for name, want, have in zip(("X", "tau", "Lu", "Ld"),
                                (x_lo, out["tau"], out["Lu"], out["Ld"]),
                                got):
        check(np.array_equal(want, have), f"the resumed {name} differs "
              "from run_tud without --checkpoint")
    with open(a + ".json") as f:
        ja = json.load(f)
    with open(b + ".json") as f:
        jb = json.load(f)
    la, lb = (fast_path(collections.Counter(j["launches"]), "5c child")
              for j in (ja, jb))
    for k in (*PRODUCTION_MODES, "tud"):
        check(la[k] > 0 and lb[k] > 0,
              f"kernel {k} was not launched in the checkpointed children")
    print(f"[5c checkpoint] {CHECKPOINTED} --checkpoint: killed after batch "
          f"1 of 3 (SIGKILL in the child), one batch file left, resumed in "
          f"a fresh process; outputs byte-identical ("
          f"{'HDF5 and ' if have_h5 else ''}np.save streams; h5py "
          f"{'present' if have_h5 else 'absent'}), equal to run_tud "
          "without --checkpoint", flush=True)
    print(f"[5c checkpoint] launches, uninterrupted child: "
          f"{ja['launches']}; resumed child: {jb['launches']}", flush=True)
    print(f"[5c checkpoint] seconds a batch of 2 with checkpoints: "
          f"{['%.4f' % c for c in ja['timings']['chunk_s']]} (resumed: "
          f"{['%.4f' % c for c in jb['timings']['chunk_s']]}); without: "
          f"{['%.4f' % c for c in plain_t['chunk_s']]}; .npz writes "
          f"{['%.4f' % w for w in ja['writes']]} s; plan build "
          f"{ja['timings']['build_s']:.3f} s in the child, "
          f"{plain_t['build_s']:.3f} s here; child wall seconds: "
          f"uninterrupted {t1 - t0:.1f}, killed {t2 - t1:.1f}, resumed "
          f"{t3 - t2:.1f} [{card}]", flush=True)
    shutil.rmtree(work)
    return ja["launches"]


def jnp_lattice64(args, xs, dev):
    """The lattice of ``run_xsect``'s result ``xs`` by the reference engine
    in float64 on ``dev``: the CLI's synthetic lines (its margin and seed)
    as float64 tensors, one state at a time."""
    margin = max(50.0, args.wing_abs)
    lines = synthetic_lines(args.synthetic, nu_min=args.numin - margin,
                            nu_max=args.numax + margin, seed=args.seed,
                            device=dev, dtype=torch.float64)
    iso = IsoTables.load(device=dev, dtype=torch.float64)
    grid = torch.as_tensor(xs["X"], dtype=torch.float64, device=dev)
    rows = []
    for T, p in zip(xs["T"], xs["p"]):
        if args.profile == "ht":
            rows.append(xsect_ht(grid, lines, iso, float(T), float(p),
                                 wing_hw=args.wing_hw))
        else:
            prm = compute_line_params(lines, iso, float(T), float(p),
                                      wing_hw=args.wing_hw,
                                      profile=args.profile)
            rows.append(xsect_from_params(grid, prm, args.profile))
    return torch.stack(rows).cpu().numpy()


def phase_jnp(dev, card):
    """The reference engine on the card: the CLI's (float32) against the
    CPU's, the engine in float64 against the kernel route, its TUD against
    the CPU's."""
    for profile in ("sdvoigt", "ht"):
        args = build_parser().parse_args(
            (JNP_XS + f" --profile {profile}").split())
        kern = run_xsect(args, "cuda")
        args.engine = "jnp"
        run_xsect(args, "cuda")                    # warm
        t = {}
        got = run_xsect(args, "cuda", t)
        cpu = run_xsect(args, "cpu")
        check(got["modes"] == [], "the jnp engine ran kernel passes")
        check(np.isfinite(got["K"]).all(), f"jnp {profile}: non-finite")
        rel = np.abs(got["K"] - cpu["K"]).max() / np.abs(cpu["K"]).max()
        gap = np.abs(got["K"] - kern["K"]).max() / np.abs(kern["K"]).max()
        t0 = time.perf_counter()
        ref = jnp_lattice64(args, got, dev)
        torch.cuda.synchronize()
        secs64 = time.perf_counter() - t0
        rel64 = np.abs(kern["K"] - ref).max() / np.abs(ref).max()
        print(f"[5d jnp] xsect --engine jnp --profile {profile}, "
              f"{ref.shape[0]} states x {ref.shape[1]} points: card vs CPU "
              f"{rel:.3e} of peak, {t['run_s']:.3f} s on the card; the "
              f"kernel route ({sorted(set(kern['modes']))}) against the "
              f"engine in float64 on the card {rel64:.3e} ({secs64:.3f} s); "
              f"the float32 engine against the kernel route {gap:.3e} (not "
              f"bounded: its float32 line centres) [{card}]", flush=True)
        check(rel <= JNP_BOUND, f"jnp {profile} card vs CPU: {rel:.3e} > "
              f"{JNP_BOUND}")
        check(rel64 <= JNP_BOUND, f"kernel route {profile} vs the "
              f"float64 engine: {rel64:.3e} > {JNP_BOUND}")

    X = arange_drift_free(1000.0, 1010.0, 0.0025)
    store = synthetic_lines(2000, nu_min=950.0, nu_max=1060.0, seed=2,
                            sd_zero_frac=0.4, device=dev)
    extras = ht_extras(len(store), 5, 0.3)
    layers = {}
    for dt in (torch.float32, torch.float64):
        atm = std_atmosphere(device=dev, dtype=dt)
        layers[dt] = (
            type(store).from_numpy(**store.host, device=dev, dtype=dt),
            IsoTables.load(device=dev, dtype=dt),
            dataclasses.replace(atm, **{f: getattr(atm, f)[JNP_HT_LAYERS]
                                        for f in ("z0", "z1", "pl", "p",
                                                  "T", "vmr")}))
    lines32, iso32, atm32 = layers[torch.float32]
    reset_launches()
    want = compute_od_layers(lines32, iso32, X, atm32, profile="ht",
                             engine="pallas", ht_extras=extras)
    launches = fast_path(read_launches(), "5d kernel route")
    check(launches["ht"] > 0, "K5 was not launched by the kernel route")
    lines64, iso64, atm64 = layers[torch.float64]
    compute_od_layers(lines64, iso64, X, atm64, profile="ht",
                      ht_extras=extras)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = compute_od_layers(lines64, iso64, X, atm64, profile="ht",
                            ht_extras=extras)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    rel = float((want.double() - got).abs().max() / got.abs().max())
    print(f"[5d jnp] compute_od_layers(profile='ht', ht_extras) on "
          f"{len(JNP_HT_LAYERS)} layers x {X.size} points: the kernel route "
          f"(K5 {launches['ht']} launches) against the jnp engine in float64 "
          f"on the card {rel:.3e} of peak; {secs:.3f} s on the card "
          f"[{card}]", flush=True)
    check(bool(torch.isfinite(want).all()), "HT OD kernel route: "
          "non-finite")
    check(rel <= JNP_BOUND, f"HT OD kernel route vs the float64 "
          f"engine: {rel:.3e} > {JNP_BOUND}")

    args = build_parser().parse_args((JNP_TUD + " --engine jnp").split())
    run_tud(args, "cuda")                          # warm
    t = {}
    _, gpu = run_tud(args, "cuda", t)
    t0 = time.perf_counter()
    _, cpu = run_tud(args, "cpu")
    cpu_s = time.perf_counter() - t0
    _, kern = run_tud(build_parser().parse_args(JNP_TUD.split()), "cuda")
    for k in ("tau", "Lu", "Ld"):
        rel = np.abs(gpu[k] - cpu[k]).max() / np.abs(cpu[k]).max()
        gap = np.abs(gpu[k] - kern[k]).max() / np.abs(kern[k]).max()
        print(f"[5d jnp] tud --engine jnp 718-720 cm^-1, 2 members, {k}: "
              f"card vs CPU {rel:.3e} of peak; against the kernel route on "
              f"the card {gap:.3e} (not bounded: float32 line centres and "
              f"the members' unclamped wings)", flush=True)
        check(rel <= SLICE_BOUND, f"jnp slice {k}: {rel:.3e} > "
              f"{SLICE_BOUND}")
    print(f"[5d jnp] tud --engine jnp: {t['members_s'] / 2:.3f} s a member "
          f"on the card, {cpu_s / 2:.3f} s on the CPU [{card}]", flush=True)


JAC_KEYS = [f"d{prod}_d{var}" for var in ("T", "H2O", "O3")
            for prod in ("tau", "Lu", "Ld")]


def phase_jacobian(card):
    """The Jacobian path at full width, then a small band card vs CPU."""
    args = build_parser().parse_args((PRODUCTION + " --jacobian").split())
    timings = {}
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    x_lo, out = run_tud(args, "cuda", timings)
    launches = fast_path(read_launches(), "5b Jacobian path")
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    print(f"[5b jacobian] launches during run_tud --jacobian: "
          f"{dict(launches)}", flush=True)
    for k in ("full", "jvp", "tud", "tud_jvp"):
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

    # 2 cm^-1: the CPU's 198 directions take about two minutes at 718-723
    # on a slow host
    small = build_parser().parse_args(
        "tud --derived --line-mixing --continuum mt_ckd --numin 718 "
        "--numax 720 --dv 0.005 --n-atmos 1 --batch 1 --jacobian".split())
    t0 = time.perf_counter()
    _, gpu = run_tud(small, "cuda")
    t1 = time.perf_counter()
    _, cpu = run_tud(small, "cpu")
    t2 = time.perf_counter()
    for k in JAC_KEYS:
        rel = np.abs(gpu[k] - cpu[k]).max() / np.abs(cpu[k]).max()
        print(f"[5b slice] 718-720 cm^-1 at 5e-3, {k}: card vs CPU plain "
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
    launches = fast_path(read_launches(), "7 xsect")
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
    bench_launches = fast_path(read_launches(), "7 bench")
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
        path_launches[prof] = fast_path(read_launches(), "7 paths")[prof]
        check(path_launches[prof] > 0 and np.isfinite(r["K"]).all(),
              f"xsect --profile {prof} did not run its kernel")
    fn1 = make_xsect_fn(store_b, IsoTables.load(device=dev),
                        arange_drift_free(*XS_SUB), XS_T, np.ones_like(XS_T),
                        profile="sdvoigt", wing_abs=XS_WING, two_pass=False)
    reset_launches()
    check(bool(torch.isfinite(fn1(T, p)).all()), "two_pass=False lattice")
    torch.cuda.synchronize()
    path_launches["sdvoigt"] = fast_path(read_launches(),
                                         "7 two_pass=False")["sdvoigt"]
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
    # each pass's plan work as its builder's work_report gives it (JAX's
    # plan_executed_evals: dense slots, padding included), beside the
    # in-window evaluations the kernels run after culling
    culled = {m: 0 for m in PRODUCTION_MODES}
    check(len(od_fn.work_report) == len(od_fn.calls), "work_report entries")
    for (lay, dplan, mode), rep in zip(od_fn.calls, od_fn.work_report):
        evals = plan_executed_evals(dplan, lay.numel())
        check(rep["mode"] == mode and rep["evals"] == evals,
              f"work_report entry {rep} against its {mode} pass")
        slot_points[mode] += evals
        counts = window_counts(lay, dplan, prm)
        n_win, (n_core,), _ = counts
        culled[mode] += n_win
        ops, nbytes = k1_bound_work(mode, lay, dplan, prm, counts)
        work[mode] = [work[mode][0] + ops, work[mode][1] + nbytes]
        issue[mode] += k1_issue_work(mode, lay, dplan, prm, counts,
                                     od_fn.fast_rcp)
        print(f"[6 evaluations] {mode} pass, {lay.numel()} layers: "
              f"in-window {n_win:.4g}, in-core {n_core:.4g} (window_counts, "
              f"after culling); plan evals {evals} (work_report, JAX's "
              f"plan_executed_evals); in-window / plan "
              f"{n_win / evals:.4f}", flush=True)
    plan_ops = sum(r["evals"] * _ops_per_eval(r["n_weideman"], r["mode"])
                   for r in od_fn.work_report)
    print("[6 work_report] per member, plan evals (work_report) / in-window "
          "(window_counts): " + ", ".join(
              f"{m} {slot_points[m]} / {culled[m]} "
              f"({culled[m] / slot_points[m]:.4f})" for m in PRODUCTION_MODES)
          + f"; the plan's lane operations (JAX's _ops_per_eval) "
          f"{plan_ops:.6e} [{card}]", flush=True)
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
    full_issue = k3_instr = k3_dense = 0.0
    work = {"full": [0, 0], "jvp": [0, 0]}
    for lay, dplan, _ in od_fn.calls:
        args = (dplan, lay, prm.shift0, prm.strength, prm.gamma_d,
                prm.gamma_0, prm.wing)
        # the path's instantiations: the builder's fast_rcp (the default)
        t, _ = cuda_ms(lambda: fused_xsect.xsect_fused(
            *args, None, "full", N_WEI, fast=od_fn.fast_rcp), 3)
        ms["K1 full"] += t
        t, _ = cuda_ms(lambda: fused_xsect.xsect_fused_jvp(
            *args, *tans, N_WEI, od_fn.fast_rcp), 3)
        ms["K3 (8 dirs)"] += t
        o3, b3, instr, dense = k3_bound_work(lay, dplan, prm, tans,
                                             od_fn.fast_rcp)
        k3_instr += instr
        k3_dense += dense
        for k, (o, b) in (("full", k1_bound_work("full", lay, dplan, prm)),
                          ("jvp", (o3, b3))):
            work[k] = [work[k][0] + o, work[k][1] + b]
        full_issue += k1_issue_work("full", lay, dplan, prm,
                                    fast=od_fn.fast_rcp)
    ms["continuum + tangents"], _ = cuda_ms(
        lambda: vjvp(lambda T_: od_fn.cont(T_, p, pl, vmr), T), 3)
    ms["OD + tangents"], (od, od_t) = cuda_ms(
        lambda: vjvp(lambda T_: od_fn(T_, p, pl, vmr), T), 1)
    # the Jacobians' composition: K2 and its tangent mode
    compose = make_tud_diff_fn(base.z0, alts, n_angles=30, devices=[dev])
    ms["K2 primal"], _ = cuda_ms(lambda: compose(grid, od, T), 3)
    ms["K2 + tangent mode (8 dirs)"], tan = cuda_ms(
        lambda: torch.func.vmap(lambda ot, tt: torch.func.jvp(
            lambda o, t_: compose(grid, o, t_), (od, T), (ot, tt))[1])(
            od_t, V), 1)
    op = reduce_operator(X, 0.25, device=dev)
    ms["reduce (8 dirs)"], _ = cuda_ms(
        lambda: [op(a.movedim(0, -1)) for a in tan], 3)

    def forward(T_):
        return compose(grid, od_fn(T_, p, pl, vmr), T_)

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
          + "; K3 in issue slots {bound_ms_issue:.4f} "
          "({bound_ms_issue_measured:.4f} at the measured FMUL rate)".format(
              **issue_bounds(k3_instr, work["jvp"][1]))
          + f"; K3 charging each live pair all 8 directions "
          f"{bound(k3_dense, work['jvp'][1])[0]:.4f} [{card}]", flush=True)


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
    # as the JAX bench calls it (bench.py:574,654): the isotopologue
    # tables and the states on the card
    dev = store.sw.device
    on_card = lambda a: torch.as_tensor(  # noqa: E731
        np.asarray(a, dtype=np.float64), device=dev)
    W_card = ht_wing_bounds(resolved, store.host_view(),
                            IsoTables.load(device=dev, dtype=torch.float64),
                            on_card(T), on_card(p_atm))
    check(np.array_equal(W_card, W), "ht_wing_bounds on card tensors "
          "differs from the host call")
    nu0 = np.broadcast_to(store.host["nu0"], W.shape)
    lo = np.searchsorted(X, (nu0 - W).ravel(), side="right")
    hi = np.searchsorted(X, (nu0 + W).ravel(), side="right")
    return int((hi - lo).sum())


def ht_evals(lay, dplan, prm, mask):
    """{piece of HT_PIECES: count} of one HT pass over the (nLay, L) pairs
    ``mask``: the in-window evaluations by the branch they take (PART4
    pairs (Gamma2 != 0) with each CPF point's w(Z) by its own region, the
    CPF3 test where the point of the wider region lies in it, PART1 pairs
    by |x| + y < 15 and the |Z1| <= 4e3 radius), and the (layer, line)
    pairs with an in-window evaluation; and the distinct lines read."""
    part4 = ((prm.ht_consts[3] != 0) | (prm.ht_consts[4] != 0)).cpu().numpy()
    n4, n_in, n_lines, p4 = window_counts(lay, dplan, prm, part4 & mask,
                                          region="ht4", pairs=True)
    n1, (n_w, n_near), _, p1 = window_counts(lay, dplan, prm, ~part4 & mask,
                                             region="ht1", pairs=True)
    return {"part4": n4, "cpf3_test": max(n_in), "part1": n_near,
            "part1_big": n1 - n_near, "w_wei": sum(n_in) + n_w,
            "w_asym": 2 * n4 - sum(n_in) + n1 - n_w,
            "pair4": p4, "pair1": p1}, n_lines


def ht_bound_work(lay, dplan, prm, tangents=None, fast=False):
    """(lane-ops, bytes, lane-instructions) of one K5 pass, or of one K6
    launch set for the (nd, nLay, L) ``tangents``: each piece (ht_evals) at
    its HT_PIECES value count, once for the pairs a tangent is live on, and
    (K6) at its per-direction count once per live (pair, direction),
    K6's rows evaluating each live direction alone; the same in the SASS
    lane-instructions of ``ht_issue`` (a direction's: K6's count less
    K5's IEEE one; ``fast``: K5's FAST instantiation's). The bound
    charging every live pair all nd directions' tangent work, as the dense
    direction axis of an earlier K6 did, is the fourth element (K6 only)."""
    live = None if tangents is None else live_directions(tangents)
    mask = (np.ones(tuple(prm.strength.shape), dtype=bool) if live is None
            else live.any(axis=0))
    ev, n_lines = ht_evals(lay, dplan, prm, mask)
    n_eval = ev["part4"] + ev["part1"] + ev["part1_big"]
    c5 = ht_issue(False, fast and tangents is None)
    ops = sum(n * HT_PIECES[k][0] for k, n in ev.items())
    instr = sum(n * c5[k] for k, n in ev.items()) + n_eval * c5["acc"]
    nl = lay.numel()
    nd = 0 if live is None else len(live)
    nbytes = (4 * (13 + 12 * nd) * nl * n_lines + 16 * dplan.k_line.numel()
              + 4 * max(nd, 1) * nl * dplan.n_out)
    if live is None:
        return ops, nbytes, instr
    ops += sum(n * HT_PIECES[k][1] for k, n in ev.items())
    dense = ops + nd * (sum(n * HT_PIECES[k][2] for k, n in ev.items())
                        + n_eval * HT_ACC_DIR)
    c6 = ht_issue(True)
    for d in range(nd):
        if not live[d].any():
            continue
        evd, _ = ht_evals(lay, dplan, prm, live[d])
        n_d = evd["part4"] + evd["part1"] + evd["part1_big"]
        ops += (sum(n * HT_PIECES[k][2] for k, n in evd.items())
                + n_d * HT_ACC_DIR)
        instr += (sum(n * (c6[k] - c5[k]) for k, n in evd.items())
                  + n_d * (c6["acc"] - c5["acc"]))
    return ops, nbytes, instr, dense


def ht_bound_str(ops, nbytes, instr, dense=None):
    """A K5 or K6 pass's bounds for the log lines: at 67 TFLOP/s (and the
    measured peak), in issue slots, and (K6) charging every live pair all
    the batch's directions."""
    out = (bound_str(ops, nbytes) + "; in issue slots {bound_ms_issue:.4f} "
           "({bound_ms_issue_measured:.4f} at the measured FMUL rate)".format(
               **issue_bounds(instr, nbytes)))
    if dense is not None:
        out += (f"; charging each live pair every direction "
                f"{bound(dense, nbytes)[0]:.4f}")
    return out


def k4_bound_work(lay, dplan, prm, tangents, fast=False):
    """(lane-ops, bytes, lane-instructions, lane-ops counting every
    direction) of one K4 launch set for the (nd, nLay, L) tangents of
    (shift0, strength, gamma_d, gamma_0, gamma_2), K3's convention: each
    live (pair, point) evaluation's shared work once (K4_BASE, and each CPF
    point's (K, Kx, Ky) by its own region) and each live direction's term of
    it (K4_DIR: K4's rows evaluate only those); the same in the SASS
    lane-instructions of ``k4_issue`` (``fast``: the FAST instantiation's);
    and the count that charges every
    live pair all nd directions' terms, as a dense direction axis
    would."""
    live = live_directions(tangents)
    n_win, n_in, n_lines = window_counts(lay, dplan, prm, live.any(axis=0),
                                         region="sd")
    n_dir = window_counts(lay, dplan, prm, live.sum(axis=0))[0]
    nd, nl = len(live), lay.numel()
    nbytes = (4 * (6 + 5 * nd) * nl * n_lines + 16 * dplan.k_line.numel()
              + 4 * nd * nl * dplan.n_out)
    shared = n_win * K4_BASE + cpf_pair_ops(n_win, n_in, KG_WEI, KG_ASYM)
    c = k4_issue(fast)
    instr = (n_win * c["base"] + cpf_pair_ops(n_win, n_in, c["in"], c["out"])
             + n_dir * c["dir"])
    return (shared + K4_DIR * n_dir, nbytes, instr,
            shared + K4_DIR * nd * n_win)


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


def ht_primal(call, prm, plain=False, fast=True):
    """One pass of an HT builder through its kernel (``fast``: in its FAST
    instantiation, the builders' default) or its plain version (``fast``:
    of the FAST instantiation's arithmetic)."""
    lay, dplan, mode = call
    if mode == "ht":
        f = fused_ht.xsect_ht_plain if plain else fused_ht.xsect_ht
        return f(dplan, lay, prm.strength, prm.wing, prm.ht_consts, N_WEI,
                 fast)
    f = fused_xsect.xsect_fused_plain if plain else fused_xsect.xsect_fused
    return f(dplan, lay, prm.shift0, prm.strength, prm.gamma_d, prm.gamma_0,
             prm.wing, None, mode, N_WEI,
             gamma_2=prm.gamma_2 if mode == "sdvoigt" else None, fast=fast)


def ht_tangent(call, prm, tans, plain=False, fast=True):
    """The tangent of one pass of the differentiable HT builder: K6 (ht,
    IEEE whatever ``fast``), K4 (sdvoigt) or K3 (full), in their FAST
    instantiations with ``fast`` (the builders' default), or its plain
    version (of the same arithmetic); ``tans`` as :func:`ht_od_tangents`
    gives them."""
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
                 N_WEI, fast)
    f = (fused_xsect.xsect_fused_jvp_plain if plain
         else fused_xsect.xsect_fused_jvp)
    return f(*args, prm.wing, s0_t, s_t, gd_t, g0_t, N_WEI, fast)


HT_TANGENT_NAME = {"ht": "K6", "sdvoigt": "K4", "full": "K3"}
# the SD-Voigt OD's line parameters with tangents (phase 9d)
SD_KEYS = ("shift0", "strength", "gamma_d", "gamma_0", "gamma_2")
# phase 9d holds K4 against its plain version on this many of its plans'
# tiles from this wavenumber (cm^-1) on: each a tile of several slices
SD_CHECK_TILES = (800.0, 4)


def sub_plan(dplan, t0, t1):
    """Tiles t0 .. t1 - 1 of ``dplan`` as a plan of their own: their slots,
    with grid indices counted from tile t0's first point."""
    starts = dplan.starts.cpu().numpy()[t0:t1].astype(np.int64)
    counts = dplan.counts.cpu().numpy()[t0:t1].astype(np.int64)
    blocks = np.concatenate([np.arange(s, s + c) for s, c in
                             zip(starts, counts)] + [np.zeros(0, np.int64)])
    slots = torch.as_tensor((blocks[:, None] * dplan.block
                             + np.arange(dplan.block)).reshape(-1),
                            device=dplan.line.device)
    line = dplan.line[slots]
    k_line = dplan.k_line[slots]
    return dataclasses.replace(
        dplan, n_tiles=t1 - t0, max_blocks=int(counts.max(initial=0)),
        n_out=min(dplan.n_out, t1 * dplan.tile) - t0 * dplan.tile,
        starts=torch.as_tensor(np.cumsum(counts) - counts, dtype=torch.int32,
                               device=line.device),
        counts=torch.as_tensor(counts, dtype=torch.int32, device=line.device),
        k_line=torch.where(line >= 0, k_line - t0 * dplan.tile, k_line),
        frac0=dplan.frac0[slots], line=line, wcap=dplan.wcap[slots])


def sd_regimes(dplan, lay, prm):
    """(closed form, whole window, empty): the (layer, line) pairs of the
    plan's slots by the Weideman range that csrc/fused_xsect_jvp.cu::
    sd_near_range gives them (its float32 P = |Re X + c^2| against R^2 =
    (15 + c)^2, in sd_pair's operations)."""
    g = dplan.line[dplan.line >= 0].long()
    q = {k: getattr(prm, k)[lay.long()][:, g].float()
         for k in ("gamma_d", "gamma_0", "gamma_2")}
    cte = (1.0 / q["gamma_d"]) * SQRT_LN2
    g2 = torch.maximum(q["gamma_2"], 1e-4 * q["gamma_0"] + 1e-12)
    inv_g2 = 1.0 / g2
    cc = (1.0 / (cte * g2)) * 0.5
    P = ((q["gamma_0"] - 1.5 * g2) * inv_g2 + cc * cc).abs()
    R2 = (15.0 + cc) * (15.0 + cc)
    empty = P >= R2 * 1.001
    whole = ~empty & ~(P <= 0.9 * R2)
    return (int((~empty & ~whole).sum()), int(whole.sum()), int(empty.sum()))


def k4_against_plain(call, prm, tans, out, card, label):
    """K4's output ``out`` of one sdvoigt pass (all its layers, the whole
    grid) against the plain version on SD_CHECK_TILES of the pass's plan,
    direction by direction, each within K4_BOUND of its own peak (exactly
    zero where the plain version is); returns the sd_regimes of the band's
    pairs."""
    lay, dplan, _ = call
    nu0, dnu = HT_BAND[0], HT_BAND[2]
    t0 = min(int((SD_CHECK_TILES[0] - nu0) / dnu) // dplan.tile,
             max(0, dplan.n_tiles - SD_CHECK_TILES[1]))
    t1 = min(t0 + SD_CHECK_TILES[1], dplan.n_tiles)
    sp = sub_plan(dplan, t0, t1)
    want = ht_tangent((lay, sp, "sdvoigt"), prm, tans, plain=True)
    k0 = t0 * dplan.tile
    got = out[:, :, k0:k0 + sp.n_out]
    k4_f64_reading(label, (lay, sp, "sdvoigt"), prm, tans, got, card)
    rels = []
    for d in range(want.shape[0]):
        err = (got[d] - want[d]).abs().max().item()
        own = want[d].abs().max().item()
        check(bool(torch.isfinite(got[d]).all()), f"9d K4 {label}: "
              f"direction {d} not finite")
        check(err <= K4_BOUND * own if own > 0.0 else err == 0.0,
              f"9d K4 {label} direction {d}: max|kernel-plain| "
              f"{err:.3e} against its own peak {own:.3e}")
        rels.append(err / own if own > 0.0 else err)
    reg = sd_regimes(sp, lay, prm)
    print(f"[9d K4 vs plain] {label}: layers {lay.numel()}, tiles {t0}-"
          f"{t1 - 1} of {dplan.n_tiles} (tile {dplan.tile}, "
          f"{-(-dplan.tile // 128)} slices a tile), {want.shape[0]} "
          f"directions: max|kernel-plain| of each direction's own peak "
          f"{max(rels):.3e} (bound {K4_BOUND}); the band's (layer, line) "
          f"pairs by Weideman range: closed form {reg[0]}, whole window "
          f"{reg[1]}, none {reg[2]} [{card}]", flush=True)
    return reg


def k4_f64_reading(label, call, prm, tans, got, card):
    """K4's FAST output ``got`` on ``call``'s band against the plain
    version in float64 on the same parameters and tangents, beside the IEEE
    instantiation and the float32 plain version (IEEE division), each
    direction of its own float64 peak (the worst printed); FAST no further
    from the float64 result than the float32 plain version is, plus
    K4_BOUND."""
    ieee = ht_tangent(call, prm, tans, fast=False)
    want = ht_tangent(call, prm, tans, plain=True, fast=False)
    ref = ht_tangent(call, params64(prm), [t.double() for t in tans],
                     plain=True)
    worst = dict.fromkeys(("FAST", "IEEE", "plain float32"), 0.0)
    for d in range(ref.shape[0]):
        own = ref[d].abs().max().item()
        if own == 0.0:
            continue
        gaps = f64_gaps({"FAST": got[d], "IEEE": ieee[d],
                         "plain float32": want[d]}, ref[d], own)
        worst = {k: max(v, gaps[k]) for k, v in worst.items()}
        limit = gaps["plain float32"] + K4_BOUND
        check(gaps["FAST"] <= limit, f"9d K4 {label} direction {d} "
              f"FAST vs float64: {gaps['FAST']:.3e} of its own peak > "
              f"the float32 plain version's + {K4_BOUND} = "
              f"{limit:.3e}")
    print(f"[float64] 9d K4 {label}: against the plain version in float64, "
          "the worst direction's share of its own peak: " + ", ".join(
              f"{k} {v:.3e}" for k, v in worst.items()) + f" [{card}]",
          flush=True)


def phase_ht_sub(dev, card):
    """3d: every pass of make_ht_fn and make_od_ht_fn(differentiable=True)
    over 800-810 cm^-1 against its plain version (K5, K1 sdvoigt and full),
    and each tangent pass of the latter (K6, K4, K3) for a T direction over
    all layers and 8 one-hot T directions, each in both instantiations but
    K6 (IEEE only); returns the JSON fields of K5, K6 and K4 (times and
    bound from the 8-direction batch; K5 and K4 also FAST) and the IEEE
    instantiations' launches of both builders with fast_rcp=False."""
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
    # each pass in its FAST instantiation (the builders' default) and its
    # IEEE one (K6: IEEE only, as JAX's tangent kernel)
    runs = [("lattice", lat, prm_l, c, None, None, f) for c in lat.calls
            for f in (True, False)]
    runs += [("layered OD", odf, prm_o, c, None, None, f) for c in odf.calls
             for f in (True, False)]
    runs += [("layered OD", odf, prm_o, c, name, tans, f) for c in odf.calls
             for name, tans in sets.items()
             for f in ((False,) if c[2] == "ht" else (True, False))]
    timed = time_kernels(
        (f"3d {c[2]}", (lambda c=c, prm=prm, tans=tans, f=f:
                        ht_primal(c, prm, fast=f) if tans is None
                        else ht_tangent(c, prm, tans, fast=f)))
        for _, _, prm, c, _, tans, f in runs)
    peaks = {"lattice": lat.line_sum(prm_l).abs().max().item(),
             "layered OD": odf.line_sum(prm_o).abs().max().item()}
    stats, plain, outs = {}, {}, {}
    for (label, fn, prm, call, name, tans, fast), (k_ms, k_out) in zip(
            runs, timed):
        lay, dplan, mode = call
        at = (label, id(call), name)
        # the plain version of this instantiation's arithmetic
        if (at, fast) not in plain:
            plain[at, fast] = (
                cuda_ms(lambda: ht_primal(call, prm, plain=True, fast=fast),
                        1) if tans is None else
                cuda_ms(lambda: ht_tangent(call, prm, tans, plain=True,
                                           fast=fast), 1))
        p_ms, p_out = plain[at, fast]
        if tans is None:
            kname = "K5" if mode == "ht" else f"K1 {mode}"
            bound_own = HT_OWN_BOUND if mode == "ht" else XS_OWN_BOUND[mode]
            touched = True
        else:
            kname = f"{HT_TANGENT_NAME[mode]} {name}"
            bound_own = {"ht": HT_JVP_BOUND, "sdvoigt": K4_BOUND,
                         "full": K3_BOUND}[mode]
            touched = any(bool((t != 0).any(dim=0).any(dim=1)[lay.long()]
                               .any()) for t in tans)
        if fast:
            kname = kname.replace(" ", " FAST ", 1) if " " in kname \
                else kname + " FAST"
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
                    f"3d {label} {kname}: {rel:.3e} of its own peak > "
                    f"{bound_own}")
        outs[at, fast] = k_out
        if not fast and (at, True) in outs:
            fast_gap(f"3d {label} {kname} layers {lay.numel()}",
                     outs[at, True], k_out, max(own, 1e-30), card)
        key = (lambda k: fk(k) if fast else k)
        if tans is None:
            check(err <= XS_BOUND * peaks[label],
                        f"3d {label} {kname}: {err / peaks[label]:.3e} of the "
                        f"{label}'s peak > {XS_BOUND}")
            if mode == "ht":
                work = ht_bound_work(lay, dplan, prm, fast=fast)
                print(f"[3d {label}] {kname} bound {ht_bound_str(*work)} "
                      f"[{card}]", flush=True)
                add_stats(stats, key("ht"), err, k_ms, p_ms, *work[:2],
                          instr=work[2])
        elif mode == "ht":
            work = ht_bound_work(lay, dplan, prm, [tans[1], *tans[5:]])
            print(f"[3d {label}] {kname} bound {ht_bound_str(*work)} "
                  f"[{card}]", flush=True)
            if name.startswith("8"):
                add_stats(stats, "ht_jvp", err, k_ms, p_ms, *work[:2],
                          instr=work[2])
        elif mode == "sdvoigt":
            work = k4_bound_work(lay, dplan, prm, tans[:5], fast)
            print(f"[3d {label}] {kname} bound {ht_bound_str(*work)} "
                  f"[{card}]", flush=True)
            if name.startswith("8"):
                add_stats(stats, key("sdvoigt_jvp"), err, k_ms, p_ms,
                          *work[:2], instr=work[2])
    for tan, fast, kname in ((False, False, "K5"), (False, True, "K5 FAST"),
                             (True, False, "K6")):
        print(f"[3d] {kname} SASS lane-instructions per piece: " + ", ".join(
            f"{k} {v:.2f}" for k, v in ht_issue(tan, fast).items()),
            flush=True)
    for fast in (False, True):
        print(f"[3d] K4{' FAST' if fast else ''} SASS lane-instructions per "
              "piece: " + ", ".join(f"{k} {v:.2f}" for k, v in
                                    k4_issue(fast).items()), flush=True)
    # the IEEE instantiations' launches on a user's path: the lattice and a
    # jvp of the layered OD, both built with fast_rcp=False, on the sub-band
    lat_i = make_ht_fn(store, iso, X, XS_T, np.ones_like(XS_T),
                       extras=extras, fast_rcp=False)
    odf_i = make_od_ht_fn(jstore, iso, X, base, extras=jextras,
                          differentiable=True, fast_rcp=False)
    reset_launches()
    lat_i(T, p)
    torch.func.jvp(lambda T_: odf_i(T_, base.p, base.pl, base.vmr),
                   (base.T,), (torch.linspace(0.5, 1.5, n_lay, device=dev),))
    torch.cuda.synchronize()
    ieee = read_launches()
    check(all(ieee[k] > 0 and ieee[fk(k)] == 0
              for k in ("ht", "sdvoigt_jvp", "jvp", "sdvoigt", "full")),
          f"3d: the IEEE HT builders launched {dict(ieee)}")
    print(f"[3d] make_ht_fn and a jvp of make_od_ht_fn(differentiable=True), "
          f"both fast_rcp=False, on the sub-band: launches {dict(ieee)}",
          flush=True)
    return finish_stats(stats), ieee


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
    launches = fast_path(read_launches(), "9 HT lattice")
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
    check(rel <= XS_SLICE_BOUND, f"HT slice: {rel:.3e} > "
          f"{XS_SLICE_BOUND}")

    # the CLI: no HT columns, so the SD-Voigt route, coarse-far
    args = xs_args(HT_CLI)
    timings = {}
    reset_launches()
    xs = run_xsect(args, dev, timings)
    cli = fast_path(read_launches(), "9 xsect --profile ht")
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
    launches = fast_path(read_launches(), "9b layered HT OD")
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
            launches = fast_path(read_launches(), "9c HT Jacobian")
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
    20,000-line list, seed 0), a batch of 8 one-hot T directions; K4 held
    against its plain version on SD_CHECK_TILES of each sdvoigt pass's
    plan, for that batch and for a T direction over all layers."""
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
    launches = fast_path(read_launches(), "9d SD-Voigt tangents")
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

    # where the batch's tangent time goes: the line parameters and their
    # tangents, then K4 on the sdvoigt passes and K3 on the full ones
    prm = fn.line_params(base.T, p, pl, vmr)[0]
    reads = [cuda_ms(lambda: t_tangents(fn, base, V, SD_KEYS), 1)[0]
             for _ in range(3)]
    tans = [t.contiguous() for t in t_tangents(fn, base, V, SD_KEYS)]
    dense = [t.contiguous() for t in t_tangents(
        fn, base, torch.linspace(0.5, 1.5, base.n_layers, device=dev)[None],
        SD_KEYS)]
    stage = {"line params + tangents": float(np.median(reads))}
    work, n_launch = {}, collections.Counter()
    regimes = np.zeros(3, dtype=np.int64)
    for call in fn.calls:
        name = HT_TANGENT_NAME[call[2]]
        reset_launches()
        out = ht_tangent(call, prm, tans)
        n_launch[name] += sum(read_launches().values())
        if call[2] == "sdvoigt":
            # K4 against its plain version on a band of this pass's plan:
            # the one-hot batch, and a T direction over all layers (the top
            # layers' pairs near tangency take their whole window)
            k4_against_plain(call, prm, tans, out, card, "8 one-hot T")
            regimes += k4_against_plain(call, prm, dense,
                                        ht_tangent(call, prm, dense), card,
                                        "T linspace(0.5, 1.5)")
        del out
        t, _ = cuda_ms(lambda: ht_tangent(call, prm, tans), 2)
        stage[name] = stage.get(name, 0.0) + t
        add_work(work, name,
                 k4_bound_work(call[0], call[1], prm, tans, True)
                 if call[2] == "sdvoigt"
                 else k3_bound_work(call[0], call[1], prm, tans[:4], True))
    check(regimes[0] > 0 and regimes[1] > 0, "9d: the K4 check's band holds "
          f"no pair of the closed form or of the whole window: {regimes}")
    print("[9d sdvoigt jacobian] ms per stage (line params + tangents: "
          f"median of 3, range {min(reads):.3f}-{max(reads):.3f}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in stage.items())
          + "; launches " + ", ".join(f"{k} {v}" for k, v in n_launch.items())
          + "; bound ms: " + work_str(work) + f" [{card}]", flush=True)
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
            add_work(work, mode, ht_bound_work(call[0], call[1], prm,
                                               fast=True)
                     if mode == "ht"
                     else xs_bound_work(mode, call[0], call[1], prm))
        print(f"[10 {label}] ms per stage: " + ", ".join(
            f"{k} {v:.3f}" for k, v in ms.items()) + "; bound ms: "
            + work_str(work) + f" [{card}]", flush=True)
    prm = jac.line_params(base.T, base.p, base.pl, base.vmr)
    tans = ht_od_tangents(jac, base, one_hot_batch(dev))
    ms, work, n_launch = {}, {}, collections.Counter()
    reads = [cuda_ms(lambda: ht_od_tangents(jac, base, one_hot_batch(dev)),
                     1)[0] for _ in range(3)]
    ms["line params + tangents"] = float(np.median(reads))
    for call in jac.calls:
        mode = call[2]
        name = HT_TANGENT_NAME[mode]
        reset_launches()
        ht_tangent(call, prm, tans)
        n_launch[name] += sum(read_launches().values())
        t, _ = cuda_ms(lambda: ht_tangent(call, prm, tans), 2)
        ms[name] = ms.get(name, 0.0) + t
        lay, dplan = call[0], call[1]
        add_work(work, name,
                 ht_bound_work(lay, dplan, prm, [tans[1], *tans[5:]])
                 if mode == "ht" else k4_bound_work(lay, dplan, prm, tans[:5],
                                                    True)
                 if mode == "sdvoigt" else
                 k3_bound_work(lay, dplan, prm, tans[:4], True)[:2])
    print("[10 9c tangents] 8 one-hot T directions, ms per stage (line "
          f"params + tangents: median of 3, range {min(reads):.3f}-"
          f"{max(reads):.3f}): "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items()) + "; launches "
          + ", ".join(f"{k} {v}" for k, v in n_launch.items())
          + "; bound ms: " + work_str(work) + f" [{card}]", flush=True)


def add_work(work, name, w):
    """Add one pass's (ops, bytes[, instructions[, dense ops]]) to
    ``work[name]`` (phases 9d, 10)."""
    acc = work.setdefault(name, [0] * len(w))
    work[name] = [a + b for a, b in zip(acc, w)]


def work_str(work):
    """Phases 9d's and 10's bounds: K4, K5 and K6 with their issue-slot
    (and K4 and K6 their every-direction) bounds (ht_bound_str), the others
    at the FP32 peak."""
    return ", ".join(f"{m} " + (ht_bound_str(*w) if len(w) > 2
                                else bound_str(*w))
                     for m, w in work.items())


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


def k7_bound_work(mode, plan, prm, fast=False):
    """(lane-ops, bytes, lane-instructions) one K7 launch needs on these
    inputs: the in-window evaluations of every (layer, line) pair over the
    whole grid (every tile a window touches visits the line's block), at
    their region's hand count (the header of csrc/fused_xsect.cu), as for
    K1; each parameter of each line, each slot and each output element
    once; in issue slots, each needed evaluation at K1's SASS count of the
    same line shape (``k1_issue``; ``fast``: the FAST instantiation's)
    plus the compensated add's ``KAHAN_ADDS`` FADDs (core: the evaluations
    inside |x| + y < 15)."""
    n_lay, n_lines = prm.strength.shape
    dplan = fused_xsect.device_plan(plan, np.arange(n_lines), None,
                                    device="cpu")
    whole = dataclasses.replace(
        dplan, tile=dplan.n_out, n_tiles=1,
        starts=torch.zeros(1, dtype=torch.int32),
        counts=torch.tensor([plan.n_blocks], dtype=torch.int32))
    lay = torch.arange(n_lay, dtype=torch.int32)
    counts = window_counts(lay, whole, prm)
    n_win, (n_core,), _ = counts
    if mode in SIMPLE_OPS:
        ops, nbytes = n_win * SIMPLE_OPS[mode], k1_bound_work(
            "asym", lay, whole, prm, counts)[1]
        instr = n_win * (k1_issue(mode, fast)["in"] + KAHAN_ADDS)
    else:
        ops, nbytes = k1_bound_work(mode, lay, whole, prm, counts)
        instr = (k1_issue_work(mode, lay, whole, prm, counts, fast)
                 + KAHAN_ADDS * (n_core if mode == "core" else n_win))
    return ops, nbytes, instr


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
    """3e: K7 in each mode and both instantiations (IEEE, FAST) against its
    plain version on make_od_plan's shared-block plan over the sub-band
    (derived list, 66 layers); a packed plan against the shared one."""
    store, iso, X, base = unfused_case(dev, SUB_BAND)
    plan = make_od_plan(store, iso, X, base)
    cols = _line_species_cols(store.host_view(), base.mol_ids)
    prm = {p: layer_line_params(store, iso, base, cols, profile=p)
           for p in ("voigt", "lorentz", "doppler")}
    prm_of = lambda m: prm[m if m in SIMPLE_OPS else "voigt"]  # noqa
    launch = lambda m, f=False: fused_xsect.xsect_unfused(  # noqa
        plan, prm_of(m), m, fast=f)
    reset_launches()        # one counted direct launch of each mode and
    for m in K7_MODES:      # instantiation
        launch(m)
        launch(m, True)
    torch.cuda.synchronize()
    launches = read_launches()
    timed = iter(time_kernels((f"K7 {m}{' FAST' if f else ''}",
                               lambda m=m, f=f: launch(m, f))
                              for m in K7_MODES for f in (False, True)))
    runs = {}
    for m in K7_MODES:
        for f in (False, True):
            # the plain version of this instantiation's arithmetic
            p_ms, p_out = event_ms(lambda m=m, f=f: (
                fused_xsect.xsect_unfused_plain(plan, prm_of(m), m, fast=f)))
            k_ms, k_out = next(timed)
            runs[m, f] = (k_ms, k_out, p_ms, p_out)
    od_peak = runs["full", False][3].abs().max().item()
    stats = {}
    for (m, f), (k_ms, k_out, p_ms, p_out) in runs.items():
        name = f"K7 {m}{' FAST' if f else ''}"
        own = p_out.abs().max().item()
        check(own > 0.0, f"{name}: the plain pass is zero on the band")
        err = (k_out - p_out).abs().max().item()
        peak = own if m in SIMPLE_OPS else od_peak
        rel, rel_own = err / peak, err / own
        print(f"[3e {name}] 66 layers x {X.size} points, tile {plan.tile} "
              f"block {plan.block}, {plan.n_tiles} tiles, max blocks "
              f"{plan.max_blocks}: max|kernel-plain| {err:.3e} = {rel:.3e} "
              f"of the OD peak {peak:.4e} = {rel_own:.3e} of its own peak "
              f"{own:.4e}; kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms "
              f"[{card}]", flush=True)
        check(rel <= K1_BOUND, f"3e {name}: {rel:.3e} of the OD "
                    f"peak > {K1_BOUND}")
        check(rel_own <= XS_OWN_BOUND[m], f"3e {name}: "
                    f"{rel_own:.3e} of its own peak > {XS_OWN_BOUND[m]}")
        ops, nbytes, instr = k7_bound_work(m, plan, prm_of(m), f)
        add_stats(stats, fk(m) if f else m, err, k_ms, p_ms, ops, nbytes,
                  instr=instr)
        print(f"[3e {name}] bound ms {bound_str(ops, nbytes)}; issue slots "
              "{bound_ms_issue:.4f} ({bound_ms_issue_measured:.4f} at the "
              "measured FMUL rate) [{card}]".format(
                  card=card, **issue_bounds(instr, nbytes)), flush=True)
        if f:
            fast_gap(f"3e K7 {m}", k_out, runs[m, False][1], peak, card)
    packed = fused_xsect.plan_buckets_packed(
        store.host_view().nu0, plan.grid, plan.max_wing, tile=plan.tile,
        block="auto")
    got = fused_xsect.xsect_unfused(packed, prm["voigt"])
    rel = (got - runs["full", False][1]).abs().max().item() / od_peak
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
    check(rel <= ROUTE_VS_BUILDER, f"route vs "
                f"make_od_fn: {rel:.3e} > {ROUTE_VS_BUILDER}")
    del od_route, od_b, od_fn

    # where a member's time goes, K7 against its plain version
    cols = _line_species_cols(store.host_view(), base.mol_ids)
    ms = {}
    ms["line params"], prm = cuda_ms(
        lambda: layer_line_params(store, iso, base, cols), 3)
    ms["K7 full"], k_out = cuda_ms(
        lambda: fused_xsect.xsect_unfused(plan, prm), 3)
    ms["K7 full FAST"], kf_out = cuda_ms(
        lambda: fused_xsect.xsect_unfused(plan, prm, fast=True), 3)
    nu = torch.as_tensor(X, dtype=torch.float32, device=dev)
    ms["continuum"], _ = cuda_ms(lambda: continuum_od(nu, base, "mt_ckd"), 3)
    ms["route"], _ = cuda_ms(lambda: route(base), 3)
    p_ms, p_out = event_ms(lambda: fused_xsect.xsect_unfused_plain(plan,
                                                                   prm))
    err = (k_out - p_out).abs().max().item()
    rel = err / p_out.abs().max().item()
    check(rel <= K1_BOUND, f"K7 full at full width: {rel:.3e} of peak > "
          f"{K1_BOUND}")
    # the FAST instantiation against the plain version of its arithmetic
    pf_ms, pf_out = event_ms(lambda: fused_xsect.xsect_unfused_plain(
        plan, prm, fast=True))
    err_f = (kf_out - pf_out).abs().max().item()
    rel_f = err_f / pf_out.abs().max().item()
    print(f"[11 breakdown] K7 full FAST vs plain at full width {rel_f:.3e} "
          f"of peak, plain {pf_ms:.3f} ms [{card}]", flush=True)
    check(rel_f <= K1_BOUND, f"K7 full FAST at full width: {rel_f:.3e} of "
          f"peak > {K1_BOUND}")
    fast_gap("11 K7 full at full width", kf_out, k_out,
             p_out.abs().max().item(), card)
    del p_out, pf_out, kf_out
    ops, nbytes, instr = k7_bound_work("full", plan, prm)
    print(f"[11 breakdown] base state, ms per stage: "
          + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
          + f"; K7 full vs plain {rel:.3e} of peak, plain {p_ms:.3f} ms; K7 "
          f"bound ms {bound_str(ops, nbytes)}; issue slots "
          "{bound_ms_issue:.4f} ({bound_ms_issue_measured:.4f} at the "
          "measured FMUL rate) [{card}]".format(
              card=card, **issue_bounds(instr, nbytes)), flush=True)
    stats = {}
    add_stats(stats, "full", err, ms["K7 full"], p_ms, ops, nbytes,
              instr=instr)
    add_stats(stats, fk("full"), err_f, ms["K7 full FAST"], pf_ms, ops,
              nbytes, instr=k7_bound_work("full", plan, prm, True)[2])
    # the route with the fast reciprocal (pallas_opts={'fast_rcp': True},
    # JAX's evaluation option; the route's default is False, as
    # xsect_pallas's): one call on the base state, its launches counted
    reset_launches()
    od_fast = compute_od_layers(store, iso, X, base, engine="pallas",
                                plan=plan, continuum="mt_ckd",
                                pallas_opts={"fast_rcp": True})
    torch.cuda.synchronize()
    fast_launches = read_launches()
    check(fast_launches[fk("unfused_full")] == 1
          and not [k for k, v in fast_launches.items()
                   if v and k != fk("unfused_full")],
          f"the route with fast_rcp=True launched {dict(fast_launches)}")
    check(bool(torch.isfinite(od_fast).all()), "the fast route's OD is not "
          "finite")
    del od_fast
    print(f"[11 route] compute_od_layers(plan=..., pallas_opts={{'fast_rcp': "
          f"True}}) on the base state: launches {dict(fast_launches)}",
          flush=True)
    launches = launches + fast_launches

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
    check(rel_b <= K1_BOUND, f"make_od_fn card vs CPU float64: "
          f"{rel_b:.3e} > {K1_BOUND}")
    fin = finish_stats(stats)
    return {"full": fin["full"], fk("full"): fin[fk("full")]}, launches


# --------------------------------------------------------------------------
# 12. the sharded production path on a virtual mesh of the one card
# --------------------------------------------------------------------------

SHARD_MESH = (2, 2)            # (ensemble, spectrum), every entry cuda:0
SHARD_EDGE_TILES = 4           # tiles at each end of a shard held vs plain
SHARD_OD_BOUND = 2e-6          # sharded vs unsharded OD, of peak (K1's)
SHARD_JAC_BOUND = 1e-4         # sharded vs unsharded tangents, own peak
#: tud --mesh-* (envelope plans) vs phase 5's run_tud (base-state plans),
#: of peak: tests/test_torch_cli.py's bound for the same cause, the
#: members' wings clamped by plans sized on the base state
MESH_VS_MAIN_BOUND = 1e-3
#: one Jacobian batch of 8 directions: T at layers 0, 30, 65; H2O at 5, 40;
#: O3 at 10, 50; T at 20 (jacobian_directions' order: T, H2O, O3 by layer)
SHARD_JAC_DIRS = [0, 30, 65, 66 + 5, 66 + 40, 132 + 10, 132 + 50, 20]


def virtual_mesh(dev):
    """The (2 x 2) mesh whose four entries are all ``dev``: every shard
    plan, offset and gather runs; the shards run one after another."""
    from radtxfr_tpu_torch.dist.mesh import make_mesh

    return make_mesh(*SHARD_MESH,
                     devices=[dev] * (SHARD_MESH[0] * SHARD_MESH[1]))


def shard_columns(local_fn, s, n_local):
    """Shard s's global grid indices in its local order."""
    if local_fn.point_index is not None:
        return torch.as_tensor(local_fn.point_index[s])
    return torch.arange(s * n_local, (s + 1) * n_local)


def shard_calls(local_fn, spec, s, n_local, dev):
    """Shard s's (starts, counts, tile offsets) for each call of
    ``local_fn`` on ``dev`` (a contiguous shard's scalar offset spread
    over its tiles)."""
    from radtxfr_tpu_torch.products.od import shard_slice

    loc = shard_slice(spec, s, dev)
    if isinstance(loc, dict):
        return loc["calls"]
    out = []
    for (st, ct), (_, dplan, _) in zip(loc, local_fn.calls):
        nt = n_local // dplan.tile
        out.append((st, ct, torch.full((nt,), s * n_local,
                                       dtype=torch.int32, device=dev)))
    return out


def edge_passes(local_fn, spec, n_spec, prm, Y, line_od, dev, label,
                card):
    """Each shard's K1 passes with offsets on SHARD_EDGE_TILES tiles at
    each end of the shard (the tiles whose windows cross its edges) against
    their plain versions with the same overrides: within K1_BOUND of the
    line OD of the pass's layers at those points and K1_OWN_BOUND of the
    pass's own peak; and each such launch bit-identical to the same
    columns of the whole shard's launch (local addressing, global
    offsets)."""
    from radtxfr_tpu_torch.kernels.fused_xsect import shard_plan

    n_local = local_fn.n_local
    worst = {}
    for s in range(n_spec):
        cols_all = shard_columns(local_fn, s, n_local).to(dev)
        for (lay, dplan, mode), (st, ct, off) in zip(
                local_fn.calls, shard_calls(local_fn, spec, s, n_local,
                                            dev)):
            t = dplan.tile
            nt = n_local // t
            k = min(SHARD_EDGE_TILES, nt)
            sel = torch.as_tensor(sorted({*range(k), *range(nt - k, nt)}),
                                  dtype=torch.long, device=dev)
            new = torch.arange(sel.numel(), device=dev)
            over = dict(starts=st[sel], counts=ct[sel],
                        k_offset=(off[sel] + (sel - new) * t).to(torch.int32),
                        n_tiles=sel.numel(), n_out=sel.numel() * t)
            whole = dict(starts=st, counts=ct, k_offset=off, n_tiles=nt,
                         n_out=n_local)
            call = (lay, shard_plan(dplan, **over), mode)
            got = local_fn.run_call(call, prm, Y)
            full = local_fn.run_call((lay, shard_plan(dplan, **whole), mode),
                                     prm, Y)
            loc_cols = (sel[:, None] * t + torch.arange(t, device=dev)
                        ).reshape(-1)
            check(torch.equal(got, full[:, loc_cols]),
                  f"{label} shard {s} {mode}: the edge tiles' launch differs "
                  "from the whole shard's columns")
            want = local_fn.run_call(call, prm, Y,
                                     kernel=fused_xsect.xsect_fused_plain)
            err = float((got - want).abs().max())
            peak = float(line_od[lay.long()][:, cols_all[loc_cols]]
                         .abs().max())
            own = float(want.abs().max())
            check(err <= K1_BOUND * peak,
                        f"{label} shard {s} {mode}: {err:.3e} > {K1_BOUND} "
                        f"x line OD peak {peak:.3e}")
            check(err <= K1_OWN_BOUND[mode] * own,
                        f"{label} shard {s} {mode}: {err:.3e} > "
                        f"{K1_OWN_BOUND[mode]} x own peak {own:.3e}")
            w = worst.setdefault(mode, [0.0, 0.0])
            w[0] = max(w[0], err / peak if peak else 0.0)
            w[1] = max(w[1], err / own if own else 0.0)
    print(f"[12 {label}] each shard's K1 passes on {2 * SHARD_EDGE_TILES} "
          "edge tiles with offsets vs plain (worst, of the line OD peak / of "
          "the pass's own peak): " + ", ".join(
              f"{m} {a:.3e} / {b:.3e}" for m, (a, b) in worst.items())
          + f"; each equal to the whole shard's columns [{card}]",
          flush=True)


def rel_peak(got, want):
    return float((got - want).abs().max() / want.abs().max())


def tensor_digest(t):
    """SHA-256 of a tensor's dtype, shape and bytes (on the host): equal
    digests, bit-identical tensors."""
    a = np.ascontiguousarray(t.detach().cpu().numpy())
    h = hashlib.sha256(f"{a.dtype.str}{a.shape}".encode())
    h.update(a.reshape(-1).view(np.uint8))
    return h.hexdigest()


def sharded_inputs(dev):
    """Phase 12's production inputs on ``dev`` (the derived lines, the
    isotope tables, the standard atmosphere, the axis, the mixing
    coefficients, the 4 members and their batch), made from the
    PRODUCTION command's seed (phase 16's processes make the same)."""
    from radtxfr_tpu_torch.dist.ensemble import stack_states

    f32 = torch.float32
    args = build_parser().parse_args(PRODUCTION.split())
    store = derived_lwir_linelist(args.numin - MARGIN, args.numax + MARGIN,
                                  device=dev, dtype=f32)
    base = std_atmosphere(device=dev, dtype=f32)
    draws = ensemble_draws(args.n_atmos, args.seed)
    states = []
    for i in range(args.n_atmos):
        T, vmr = ensemble_member(base, draws, i)
        states.append(dataclasses.replace(base, T=T, vmr=vmr))
    return dict(args=args, store=store,
                iso=IsoTables.load(device=dev, dtype=f32), base=base,
                X=arange_drift_free(args.numin, args.numax, args.dv),
                lm={"y_air": y_air_for_store(store.host_view())},
                states=states, batch=stack_states(states))


def phase_sharded(dev, card, x_main, main_products):
    """12: the sharded production path (``dist/fused_ensemble.py``) at full
    production width on a virtual (2 x 2) mesh of the one card: the
    ensemble (equal and weighted partitions) against the unsharded builder
    on the same padded grid and plans, each shard's K1 passes with offsets
    against their plain versions, one sharded Jacobian batch against the
    unsharded tangents, K4 with offsets, the line-sharded OD, ``run_tud``
    with the mesh and ``--checkpoint`` (and against phase 5's products),
    and the cost of sharding on one card (not a multi-card speed-up)."""
    from radtxfr_tpu_torch.dist.ensemble import gather_shards
    from radtxfr_tpu_torch.dist.fused_ensemble import (
        _envelope, jacobian_directions, make_tud_ensemble_fn,
        make_tud_jacobian_fn)
    from radtxfr_tpu_torch.kernels.fused_xsect import shard_plan
    from radtxfr_tpu_torch.products.od import make_od_local_fn, shard_slice
    from radtxfr_tpu_torch.products.od_sharded_lines import (
        make_od_sharded_lines_fn)

    f32 = torch.float32
    inp = sharded_inputs(dev)
    args, store, iso, base, X, lm, states, batch = (
        inp[k] for k in ("args", "store", "iso", "base", "X", "lm", "states",
                         "batch"))
    env = _envelope(batch)
    mesh = virtual_mesh(dev)
    n_spec = SHARD_MESH[1]
    out, launches, offsets, times, digests = {}, {}, {}, {}, {}
    for part in ("equal", "weighted"):
        t0 = time.perf_counter()
        gpad, run = make_tud_ensemble_fn(
            store, iso, X, batch, ALTITUDES, mesh, continuum="mt_ckd",
            line_mixing=lm, partition=part)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        reset_launches()
        fused_xsect.OFFSET_LAUNCHES.clear()
        out[part] = run(batch)
        torch.cuda.synchronize()
        launches[part] = fast_path(read_launches(), f"12 ensemble {part}")
        offsets[part] = dict(fast_path(fused_xsect.OFFSET_LAUNCHES,
                                       f"12 ensemble {part} offsets"))
        digests[part] = [tensor_digest(t) for t in out[part]]
        for k in (*PRODUCTION_MODES, "tud"):
            check(launches[part][k] > 0, f"kernel {k} was not launched by "
                  f"the sharded ensemble ({part})")
        for k in PRODUCTION_MODES:
            check(offsets[part].get(k, 0) > 0, f"K1 {k} was not launched "
                  f"with tile offsets by the sharded ensemble ({part})")
        times[part], _ = cuda_ms(lambda: run(batch), 2)
        print(f"[12 ensemble] {part}: {args.n_atmos} members on a "
              f"{SHARD_MESH} virtual mesh, {gpad.n} padded points; plan "
              f"build {build_s:.3f} s; launches {dict(launches[part])}, with "
              f"offsets {offsets[part]} [{card}]", flush=True)

    # the unsharded builder on the same padded grid, class and options
    t0 = time.perf_counter()
    od_fn = make_od_fn(store, iso, gpad, env, continuum="mt_ckd",
                       line_mixing=lm, group_ratio=1.6, far_method="classic")
    torch.cuda.synchronize()
    build_u = time.perf_counter() - t0
    x_pad = torch.as_tensor(gpad.values(), dtype=f32, device=dev)
    tud_fn = make_tud_fn(base.z0.cpu().numpy(), ALTITUDES, device=dev)

    def unsharded(st):
        return tud_fn(x_pad, od_fn(st.T, st.p, st.pl, st.vmr), st.T)

    errs = {part: [0.0, 0.0, 0.0] for part in out}
    same = {part: True for part in out}
    for i, st in enumerate(states):
        ref = unsharded(st)
        for part, prods in out.items():
            for j, (got, want) in enumerate(zip(prods, (ref.tau, ref.Lu,
                                                        ref.Ld))):
                errs[part][j] = max(errs[part][j], rel_peak(got[i], want))
                same[part] &= bool(torch.equal(got[i], want))
    for part in out:
        for j, name in enumerate(("tau", "Lu", "Ld")):
            check(errs[part][j] <= K2_BOUND, f"sharded {part} {name}: "
                  f"{errs[part][j]:.3e} of peak > {K2_BOUND}")
        print(f"[12 ensemble] {part} vs the unsharded builder on the same "
              f"padded grid (K1 + K2), 4 members: tau/Lu/Ld "
              + "/".join(f"{e:.3e}" for e in errs[part]) + " of peak; "
              + ("bit-identical" if same[part] else "NOT bit-identical")
              + f" [{card}]", flush=True)
    unsh_ms, _ = cuda_ms(lambda: [unsharded(st) for st in states], 2)

    # the OD itself, each shard's passes against plain, and the breakdown
    st0 = states[0]
    T, p, pl, vmr = st0.T, st0.p, st0.pl, st0.vmr
    od_ref = od_fn(T, p, pl, vmr)
    line_od = od_fn.line_sum(*od_fn.line_params(T, p, pl, vmr))
    for part in ("equal", "weighted"):
        local_fn, spec, g = make_od_local_fn(
            store, iso, X, env, n_spec, continuum="mt_ckd", line_mixing=lm,
            partition=part)
        n_local = g.n // n_spec
        specs = [shard_slice(spec, s, dev) for s in range(n_spec)]
        shards = [local_fn(T, p, pl, vmr, specs[s], s * n_local)
                  for s in range(n_spec)]
        od = torch.empty_like(od_ref)
        for s in range(n_spec):
            od[:, shard_columns(local_fn, s, n_local).to(dev)] = shards[s]
        err = rel_peak(od, od_ref)
        check(err <= SHARD_OD_BOUND, f"sharded OD ({part}) {err:.3e} of "
              f"peak > {SHARD_OD_BOUND}")
        print(f"[12 od] {part}: the gathered sharded OD vs the unsharded "
              f"make_od_fn on the same padded grid and options: {err:.3e} "
              f"of peak, " + ("bit-identical" if torch.equal(od, od_ref)
                              else "NOT bit-identical") + f" [{card}]",
              flush=True)
        prm, Y = local_fn.line_params(T, p, pl, vmr)
        edge_passes(local_fn, spec, n_spec, prm, Y, line_od, dev,
                    f"{part} K1 edges", card)
        # where a sharded member's time goes (both shards, one card)
        ms = {"line params": 0.0, "K1": 0.0, "continuum": 0.0, "K2": 0.0}
        parts = {}
        for s in range(n_spec):
            ms["line params"] += cuda_ms(
                lambda: local_fn.line_params(T, p, pl, vmr), 3)[0]
            for (lay, dplan, mode), (st_, ct, off) in zip(
                    local_fn.calls, shard_calls(local_fn, spec, s, n_local,
                                                dev)):
                sp = shard_plan(dplan, starts=st_, counts=ct, k_offset=off,
                                n_tiles=n_local // dplan.tile, n_out=n_local)
                ms["K1"] += cuda_ms(lambda: local_fn.run_call(
                    (lay, sp, mode), prm, Y), 3)[0]
            kw = (dict(k_index=specs[s]["point_idx"]) if part == "weighted"
                  else dict(k_offset=s * n_local))
            ms["continuum"] += cuda_ms(lambda: local_fn.cont(
                T, p, pl, vmr, **kw), 3)[0]
            xs = x_pad[shard_columns(local_fn, s, n_local).to(dev)]
            k2_ms, tud = cuda_ms(lambda: tud_fn(xs, shards[s], T), 3)
            ms["K2"] += k2_ms
            parts[(0, s)] = tuple(a[None] for a in (tud.tau, tud.Lu,
                                                    tud.Ld))
        ms["gather"], _ = cuda_ms(lambda: gather_shards(
            parts, dev, 1, g.n, local_fn.point_index), 3)
        print(f"[12 breakdown] {part}, one member on the virtual mesh (the "
              f"cost of sharding on one card, not a multi-card speed-up): "
              f"the ensemble {times[part] / len(states):.3f} ms a member, "
              f"the unsharded builder {unsh_ms / len(states):.3f} ms a "
              f"member (plan build {build_u:.3f} s); sharded stages: "
              + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
              + f" ms [{card}]", flush=True)

    # one sharded Jacobian batch (K1 full, K3 with offsets) vs unsharded
    t0 = time.perf_counter()
    gj, run_j = make_tud_jacobian_fn(store, iso, X, base, ALTITUDES, mesh,
                                     continuum="mt_ckd")
    V_T, V_vmr, labels = jacobian_directions(base)
    V_T, V_vmr = V_T[SHARD_JAC_DIRS], V_vmr[SHARD_JAC_DIRS]
    reset_launches()
    fused_xsect.OFFSET_LAUNCHES.clear()
    prim, tan = run_j(base.T, base.vmr, V_T, V_vmr)
    torch.cuda.synchronize()
    jac_s = time.perf_counter() - t0
    jac_launches = fast_path(read_launches(), "12 sharded Jacobian")
    jac_off = dict(fast_path(fused_xsect.OFFSET_LAUNCHES,
                             "12 sharded Jacobian offsets"))
    digests["jacobian"] = [tensor_digest(d[k]) for d in (prim, tan)
                           for k in ("tau", "Lu", "Ld")]
    for k in ("full", "jvp"):
        check(jac_launches[k] > 0 and jac_off.get(k, 0) > 0,
              f"kernel {k} was not launched with offsets by the sharded "
              "Jacobian")
    # the composition: K2 for each shard's primal, its tangent mode once a
    # mesh entry's batch of directions
    for k in ("tud", "tud_jvp"):
        check(jac_launches[k] > 0, f"kernel {k} was not launched by the "
              "sharded Jacobian")
    fn_d = make_od_fn(store, iso, gj, base, continuum="mt_ckd",
                      differentiable=True, group_ratio=1.6,
                      far_method="classic")
    x_j = torch.as_tensor(gj.values(), dtype=f32, device=dev)
    alts = torch.as_tensor(ALTITUDES, dtype=f32, device=dev)

    def forward(T_, vmr_):
        od = fn_d(T_, base.p, base.pl, vmr_)
        B = planckian(x_j, T_).transpose(0, 1).to(od.dtype)
        t = tud_from_od(x_j, od, B, base.z0, alts, n_angles=30)
        return t.tau, t.Lu, t.Ld

    vt = torch.as_tensor(V_T, device=dev)
    vv = torch.as_tensor(V_vmr, device=dev)
    want_p = forward(base.T, base.vmr)
    want_t = torch.func.vmap(lambda a, b: torch.func.jvp(
        forward, (base.T, base.vmr), (a, b))[1])(vt, vv)
    worst = worst_p = 0.0
    for j, name in enumerate(("tau", "Lu", "Ld")):
        err = rel_peak(prim[name], want_p[j])
        check(err <= SHARD_JAC_BOUND, f"sharded Jacobian primal {name}: "
              f"{err:.3e} > {SHARD_JAC_BOUND}")
        worst_p = max(worst_p, err)
        for d in range(len(SHARD_JAC_DIRS)):
            e = rel_peak(tan[name][d], want_t[j][d])
            check(e <= SHARD_JAC_BOUND, f"sharded tangent {name} "
                  f"{labels[SHARD_JAC_DIRS[d]]}: {e:.3e} > {SHARD_JAC_BOUND}")
            worst = max(worst, e)
    del want_t
    print(f"[12 jacobian] 8 directions on the virtual mesh (directions over "
          f"the ensemble axis, weighted spectrum shards): {jac_s:.3f} s "
          f"with the plan build; vs the unsharded jvp: primal within "
          f"{worst_p:.3e}, tangents within {worst:.3e} of each one's peak; "
          f"launches {dict(jac_launches)}, "
          f"with offsets {jac_off} [{card}]", flush=True)

    # K4 with offsets: the differentiable SD-Voigt OD on 2 weighted shards
    sd_store = synthetic_lines(**{**HT_JAC_LINES, "device": dev})
    X_sd = arange_drift_free(*HT_JAC_BAND)
    sd_fn, sd_spec, g_sd = make_od_local_fn(
        sd_store, iso, X_sd, base, n_spec, profile="sdvoigt",
        differentiable=True, partition="weighted")
    sd_ref = make_od_fn(sd_store, iso, g_sd, base, profile="sdvoigt",
                        differentiable=True, group_ratio=1.6)
    V = one_hot_batch(dev)
    fused_xsect.OFFSET_LAUNCHES.clear()
    n_sd = g_sd.n // n_spec
    sd_tan = torch.empty((V.shape[0], base.n_layers, g_sd.n), device=dev)
    for s in range(n_spec):
        # bound outside the transforms: their wrapped tensors have no
        # storage to hand a kernel
        shard = sd_fn.bind(shard_slice(sd_spec, s, dev), 0)
        sd_tan[:, :, shard_columns(sd_fn, s, n_sd).to(dev)] = \
            torch.func.vmap(lambda v: torch.func.jvp(
                lambda T_: shard(T_, base.p, base.pl, base.vmr),
                (base.T,), (v,))[1])(V)
    sd_off = dict(fast_path(fused_xsect.OFFSET_LAUNCHES,
                            "12 sharded SD-Voigt offsets"))
    check(sd_off.get("sdvoigt_jvp", 0) > 0,
          "K4 was not launched with offsets")
    sd_want = torch.func.vmap(lambda v: torch.func.jvp(
        lambda T_: sd_ref(T_, base.p, base.pl, base.vmr), (base.T,),
        (v,))[1])(V)
    sd_err = max(rel_peak(sd_tan[d], sd_want[d]) for d in range(V.shape[0]))
    check(sd_err <= K4_BOUND, f"sharded SD-Voigt tangents {sd_err:.3e}")
    same = "bit-identical" if torch.equal(sd_tan, sd_want) else \
        "NOT bit-identical"
    print(f"[12 sdvoigt] {HT_JAC_LINES['n_lines']} lines, 8 one-hot T "
          f"directions on 2 weighted shards (K4 and K3 with offsets "
          f"{sd_off}) vs unsharded: {sd_err:.3e} of each direction's peak, "
          f"{same} [{card}]", flush=True)

    # the line-sharded OD on 2 shards against the replicated one
    fused_xsect.OFFSET_LAUNCHES.clear()
    ls_fn, ls_data, g_ls = make_od_sharded_lines_fn(store, iso, X, base,
                                                    n_spec)
    n_ls = g_ls.n // n_spec
    ls_od = torch.cat([ls_fn(base.T, base.p, base.pl, base.vmr,
                             shard_slice(ls_data, s, dev), s * n_ls)
                       for s in range(n_spec)], dim=1)
    rep_fn, rep_spec, _ = make_od_local_fn(store, iso, g_ls, base, 1)
    rep = rep_fn(base.T, base.p, base.pl, base.vmr,
                 shard_slice(rep_spec, 0, dev), 0)
    n = X.size
    ls_err = rel_peak(ls_od[:, :n], rep[:, :n])
    check(ls_err <= SHARD_OD_BOUND, f"line-sharded OD {ls_err:.3e}")
    print(f"[12 line-sharded] 2 shards of {ls_data['lines']['nu0'].shape[1]}"
          f" line slots each (of {store.n_lines} lines) vs the replicated "
          f"OD: {ls_err:.3e} of peak; K1 with offsets "
          f"{dict(fused_xsect.OFFSET_LAUNCHES)} [{card}]", flush=True)

    # run_tud with the virtual mesh and --checkpoint in child processes
    # (phase 5c's): one killed after its first batch, a fresh one resumes
    # it; its products bit-identical to an in-process run without
    # --checkpoint
    margs = PRODUCTION.split() + ["--mesh-spectrum", "2", "--mesh-ensemble",
                                  "2"]
    timings = {}
    x_lo, full = run_tud(build_parser().parse_args(margs), "cuda", timings,
                         mesh=mesh)
    # against phase 5's single-device run_tud: its plans are sized on the
    # base state, whose wing bounds clamp the perturbed members' wings;
    # the mesh run's on the envelope of each batch, which clamps none.
    # The same cause as the jnp engine's gap to both production builders
    # in tests/test_torch_cli.py, held to that test's bound
    check(np.array_equal(x_lo, x_main), "the mesh run_tud's axis differs "
          "from phase 5's")
    gaps = {k: float(np.abs(full[k] - main_products[k]).max()
                     / np.abs(main_products[k]).max())
            for k in ("tau", "Lu", "Ld")}
    for k, gap in gaps.items():
        check(gap <= MESH_VS_MAIN_BOUND, f"the mesh run_tud {k} lies "
              f"{gap:.3e} of peak from phase 5's > {MESH_VS_MAIN_BOUND}")
    print(f"[12 run_tud] --mesh-* (envelope plans) vs phase 5's run_tud "
          f"(base-state plans), {args.n_atmos} members at production width: "
          + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items())
          + f" of peak [{card}]", flush=True)
    # with --checkpoint in this process (phase 5c kills and resumes the
    # checkpointed command in child processes): a checkpointed run, then
    # its second batch file removed and the run resumed; both bit-identical
    # to the run without --checkpoint, the resume computing only the
    # missing batch through K1 and K2
    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_ckpt_")
    ck = os.path.join(work, "ck")
    cargs = build_parser().parse_args(margs + ["--checkpoint", ck])
    t0 = time.perf_counter()
    _, first = run_tud(cargs, "cuda", mesh=mesh)
    t1 = time.perf_counter()
    listing = sorted(os.listdir(ck))
    check(listing == ["batch_000000.npz", "batch_000001.npz",
                      "manifest.json"], f"the mesh checkpoint held {listing}")
    os.remove(os.path.join(ck, "batch_000001.npz"))
    reset_launches()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        _, again = run_tud(cargs, "cuda", mesh=mesh)
    resumed = fast_path(read_launches(), "12 resumed mesh run")
    t2 = time.perf_counter()
    check("batch 1/2" not in log.getvalue()
          and "batch 2/2" in log.getvalue(),
          f"the resumed mesh run computed other batches:\n{log.getvalue()}")
    for k in (*PRODUCTION_MODES, "tud"):
        check(resumed[k] > 0, f"kernel {k} was not launched by the resumed "
              "mesh run")
    for name in ("tau", "Lu", "Ld"):
        for label, got in (("checkpointed", first), ("resumed", again)):
            check(np.array_equal(got[name], full[name]), f"the {label} "
                  f"mesh {name} differs from run_tud without --checkpoint")
            check(np.isfinite(got[name]).all(), f"mesh run_tud {name} not "
                  "finite")
    shutil.rmtree(work)
    print(f"[12 run_tud] --mesh-spectrum 2 --mesh-ensemble 2 (virtual mesh):"
          f" {args.n_atmos} members, plan build {timings['build_s']:.3f} s, "
          f"{timings['members_s'] / args.n_atmos:.4f} s a member; with "
          f"--checkpoint ({t1 - t0:.1f} s) and resumed after its second "
          f"batch file was removed ({t2 - t1:.1f} s): products "
          f"bit-identical to the run without checkpoints; the resumed run's "
          f"launches {dict(resumed)} [{card}]", flush=True)
    return {"ensemble": offsets["weighted"], "jacobian": jac_off,
            "sdvoigt": sd_off, "digests": digests, "ms": times,
            "jacobian_launches": {k: jac_launches[k]
                                  for k in ("tud", "tud_jvp")}}


# --------------------------------------------------------------------------
# 16. the sharded production path on a mesh that spans two processes
# --------------------------------------------------------------------------

SPAN_CHILD_TIMEOUT = 300
#: (b)'s band: the default global (2 x 1) mesh (one card a process, one
#: member each) against this process's own virtual (2 x 1) mesh
SPAN_SMALL = (718.0, 723.0, 0.0005)
SPAN_REPS = 3
#: a child of phase 16: joins the group and runs span_child
SPAN_CHILD = """
import sys
sys.path.insert(0, {root!r})
import chip_smoke
chip_smoke.span_child({coord!r}, {rank}, {out!r}, {want!r})
"""


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def span_child(coord, rank, out_path, want):
    """One of phase 16's two processes, both on cuda:0, in one gloo group
    (``init_multihost``). (a) The sharded ensemble on the (2 x 2) mesh whose
    ensemble row e belongs to process e, both partitions: the gathered
    products' digests against phase 12's (``want``) and the other
    process's; each batch's wall ms and the exchange's
    (``share_parts``, timed after a synchronise). (b) The default global
    mesh ``make_mesh(2, 1)``: one card a process, and its ensemble on
    SPAN_SMALL bit-identical to this process's own virtual mesh; a (2 x 2)
    default mesh raises. (c) One sharded Jacobian batch (SHARD_JAC_DIRS,
    four directions a process) against phase 12's digests. (d) Each run's
    launch counts (reset before, read after) and offset launches. A failed
    check is recorded and the run goes on, so that neither process waits
    on a collective the other never reaches; at the end process 0 writes
    both processes' records to ``out_path`` and both raise if any check
    failed."""
    import torch.distributed as dist

    from radtxfr_tpu_torch.dist import fused_ensemble as fe
    from radtxfr_tpu_torch.dist.ensemble import stack_states
    from radtxfr_tpu_torch.dist.init import init_multihost
    from radtxfr_tpu_torch.dist.mesh import make_mesh

    init_multihost(coord, 2, rank)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    fails = []

    def need(ok, msg):
        if not ok:
            fails.append(f"process {rank}: {msg}")

    def agree(label, digests):
        """The digests against phase 12's and the other process's."""
        both = [None, None]
        dist.all_gather_object(both, digests)
        need(both[0] == both[1], f"{label}: the two processes' copies "
             "differ")
        need(digests == want[label], f"{label}: not bit-identical to the "
             "one-process mesh of phase 12")

    # the exchange timed apart: this process's entries finished
    # (synchronised), then both processes at a barrier, then share_parts
    shared, own = [0.0], []
    share = fe.share_parts

    def timed_share(parts, mesh, rows=None):
        torch.cuda.synchronize()
        own.append(time.perf_counter())
        dist.barrier()
        t0 = time.perf_counter()
        got = share(parts, mesh, rows)
        shared[0] += time.perf_counter() - t0
        return got

    fe.share_parts = timed_share
    inp = sharded_inputs(dev)
    store, iso, base, X, lm, batch = (
        inp[k] for k in ("store", "iso", "base", "X", "lm", "batch"))
    rec = {"rank": rank, "members": int(batch.T.shape[0])}

    # (a) the ensemble, row e of the mesh in process e
    mesh = make_mesh(*SHARD_MESH, devices=[(e, dev) for e in range(2)
                                           for _ in range(2)])
    need(mesh.owned() == [(rank, 0), (rank, 1)],
         f"the (2 x 2) mesh gives this process {mesh.owned()}")
    for part in ("equal", "weighted"):
        t0 = time.perf_counter()
        _, run = fe.make_tud_ensemble_fn(store, iso, X, batch, ALTITUDES,
                                         mesh, continuum="mt_ckd",
                                         line_mixing=lm, partition=part)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        reset_launches()
        fused_xsect.OFFSET_LAUNCHES.clear()
        prods = run(batch)
        torch.cuda.synchronize()
        launches = fast_path(read_launches(), f"16 ensemble {part}")
        offsets = dict(fast_path(fused_xsect.OFFSET_LAUNCHES,
                                 f"16 ensemble {part} offsets"))
        for k in (*PRODUCTION_MODES, "tud"):
            need(launches[k] > 0, f"kernel {k} was not launched by the "
                 f"ensemble ({part})")
        for k in PRODUCTION_MODES:
            need(offsets.get(k, 0) > 0, f"K1 {k} was not launched with "
                 f"tile offsets by the ensemble ({part})")
        for t in prods:
            need(bool(torch.isfinite(t).all()), f"{part}: non-finite "
                 "products")
        agree(part, [tensor_digest(t) for t in prods])
        del prods
        ms, own_ms, gather_ms = [], [], []
        for _ in range(SPAN_REPS):
            shared[0] = 0.0
            own.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run(batch)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            own_ms.append((own[0] - t0) * 1e3)
            gather_ms.append(shared[0] * 1e3)
        rec[part] = dict(build_s=build_s, launches=dict(launches),
                         offsets=offsets, ms=ms, own_ms=own_ms,
                         gather_ms=gather_ms)
        del run

    # (b) the default global mesh: one card a process
    gmesh = make_mesh(2, 1)
    need(gmesh.pairs() == [(0, dev), (1, dev)] and gmesh.owned()
         == [(rank, 0)], f"make_mesh(2, 1) gave {gmesh.pairs()}, this "
         f"process {gmesh.owned()}")
    try:
        make_mesh(2, 2)
        need(False, "make_mesh(2, 2) over two processes of one card each "
             "did not raise")
    except ValueError as e:
        need(str(e) == "need 4 devices, have 2", f"make_mesh(2, 2): {e}")
    small = stack_states(inp["states"][:2])
    X_s = arange_drift_free(*SPAN_SMALL)
    _, run_g = fe.make_tud_ensemble_fn(store, iso, X_s, small, ALTITUDES,
                                       gmesh, continuum="mt_ckd",
                                       line_mixing=lm)
    got = run_g(small)
    _, run_l = fe.make_tud_ensemble_fn(store, iso, X_s, small, ALTITUDES,
                                       make_mesh(2, 1, devices=[dev, dev]),
                                       continuum="mt_ckd", line_mixing=lm)
    mine = run_l(small)
    need(all(torch.equal(a, b) for a, b in zip(got, mine)),
         "the default global (2 x 1) mesh differs from this process's own")
    rec["global_points"] = int(got[0].shape[1])
    del got, mine, run_g, run_l

    # (c) one Jacobian batch, its directions split over the processes
    t0 = time.perf_counter()
    _, run_j = fe.make_tud_jacobian_fn(store, iso, X, base, ALTITUDES, mesh,
                                       continuum="mt_ckd")
    V_T, V_vmr, _ = fe.jacobian_directions(base)
    torch.cuda.synchronize()
    jac_build_s = time.perf_counter() - t0
    reset_launches()
    fused_xsect.OFFSET_LAUNCHES.clear()
    shared[0] = 0.0
    own.clear()
    t0 = time.perf_counter()
    prim, tan = run_j(base.T, base.vmr, V_T[SHARD_JAC_DIRS],
                      V_vmr[SHARD_JAC_DIRS])
    torch.cuda.synchronize()
    jac_ms = (time.perf_counter() - t0) * 1e3
    launches = fast_path(read_launches(), "16 Jacobian")
    offsets = dict(fast_path(fused_xsect.OFFSET_LAUNCHES,
                             "16 Jacobian offsets"))
    for k in ("full", "jvp"):
        need(launches[k] > 0 and offsets.get(k, 0) > 0, f"kernel {k} was "
             "not launched with offsets by the Jacobian")
    # the tangent mode in each process, K2 where a primal is (row 0)
    for k in ("tud_jvp",) + (("tud",) if rank == 0 else ()):
        need(launches[k] > 0, f"kernel {k} was not launched by the "
             "Jacobian")
    agree("jacobian", [tensor_digest(d[k]) for d in (prim, tan)
                       for k in ("tau", "Lu", "Ld")])
    rec["jacobian"] = dict(build_s=jac_build_s, ms=jac_ms,
                           own_ms=(own[0] - t0) * 1e3,
                           gather_ms=shared[0] * 1e3,
                           launches=dict(launches), offsets=offsets)
    del prim, tan, run_j

    recs = [None, None]
    dist.all_gather_object(recs, (rec, fails))
    if rank == 0:
        with open(out_path, "w") as f:
            json.dump([r for r, _ in recs], f)
    dist.destroy_process_group()
    every = [m for _, fl in recs for m in fl]
    check(not every, "; ".join(every))


def phase_span(card, sharded):
    """16: the sharded production path on a mesh that spans two processes
    (``span_child``), both on the one card; the kernels are built (phase
    2) before the children start. Either child failing, killed or past
    SPAN_CHILD_TIMEOUT fails the phase; nothing carries on in one
    process. Returns each production kernel's launches in the two
    processes."""
    torch.cuda.empty_cache()
    work = tempfile.mkdtemp(prefix="chip_smoke_span_")
    out = os.path.join(work, "records.json")
    coord = f"127.0.0.1:{free_port()}"
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, "-c", SPAN_CHILD.format(
            root=root, coord=coord, rank=r, out=out,
            want=sharded["digests"])],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in (0, 1)]
    logs = []
    try:
        for p in procs:
            left = max(1.0, SPAN_CHILD_TIMEOUT - (time.perf_counter() - t0))
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        pass
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    # a child killed at the time limit: what it printed until then
    logs += [p.communicate()[0] for p in procs[len(logs):]]
    wall = time.perf_counter() - t0
    for r, (p, log) in enumerate(zip(procs, logs)):
        check(p.returncode == 0, f"phase 16 process {r} ended with "
              f"{p.returncode} after {wall:.1f} s (limit "
              f"{SPAN_CHILD_TIMEOUT} s):\n{log[-4000:]}")
    with open(out) as f:
        recs = json.load(f)
    shutil.rmtree(work)
    for part in ("equal", "weighted"):
        per = [r[part] for r in recs]
        print(f"[16 ensemble] {part}: {len(recs)} processes on one card, "
              f"the (2 x 2) mesh's row e in process e, {recs[0]['members']} "
              "members: each process's gathered tau/Lu/Ld bit-identical to "
              "phase 12's one-process mesh and to the other process's; "
              + "; ".join(
                  f"process {r['rank']}: plan build {p['build_s']:.3f} s, a "
                  f"batch {'/'.join('%.3f' % v for v in p['ms'])} ms, its "
                  f"own entries done at "
                  f"{'/'.join('%.3f' % v for v in p['own_ms'])} ms, the "
                  f"exchange {'/'.join('%.3f' % v for v in p['gather_ms'])} "
                  "ms, "
                  f"launches {p['launches']}, with offsets {p['offsets']}"
                  for r, p in zip(recs, per))
              + f"; one process (phase 12) {sharded['ms'][part]:.3f} ms a "
              f"batch [{card}]", flush=True)
    print(f"[16 global mesh] make_mesh(2, 1) over the two processes: "
          f"one card a process, its ensemble on {SPAN_SMALL[0]}-"
          f"{SPAN_SMALL[1]} cm^-1 ({recs[0]['global_points']} padded "
          f"points, 2 members) bit-identical to a one-process virtual "
          f"mesh; make_mesh(2, 2) raises [{card}]", flush=True)
    print(f"[16 jacobian] {len(SHARD_JAC_DIRS)} directions, 4 a process: "
          f"bit-identical to phase 12's; " + "; ".join(
              f"process {r['rank']}: plan build "
              f"{r['jacobian']['build_s']:.3f} s, the batch "
              f"{r['jacobian']['ms']:.3f} ms, its own entries done at "
              f"{r['jacobian']['own_ms']:.3f} ms, the exchanges "
              f"{r['jacobian']['gather_ms']:.3f} ms, launches "
              f"{r['jacobian']['launches']}, with offsets "
              f"{r['jacobian']['offsets']}" for r in recs)
          + f"; the two processes' wall {wall:.1f} s [{card}]", flush=True)
    return {k: [r["weighted"]["launches"].get(k, 0) for r in recs]
            for k in (*PRODUCTION_MODES, "tud")} | {
        k: [r["jacobian"]["launches"].get(k, 0) for r in recs]
        for k in ("full", "jvp", "tud_jvp")}


# phase 13: the cross-section serving path at the reference generator's
# width (misc/RT_gen_AbsXS_files.py:15-31): H2O and CO2 (the XS_CLI list's
# molecules 1 and 2, one at a time), 400-7100 cm^-1 at 0.0025, T 275-320 K
# by 5, p 0.85-1.05 atm by 0.05, SD-Voigt with 350 cm^-1 wings: 100
# (molecule, state) rows, written as AFIT_XS files, read back as the table
# od_from_xs serves phase 5's members from, composed by K2. At a lattice
# node the served OD is the column times the kernel's row (the product's
# float32 rounding and the log-p node's); on the 690-1410 cm^-1 columns the
# card's float32 product against the CPU's float64 on the same table and
# inputs; K2 against tud_from_od on the served OD (K2's bound). The rows
# themselves on the XS_SUB sub-band at all 50 states: each K1 pass there
# against its plain version, and the rows against the classic route
SERVE_MOLS = (1, 2)
SERVE_T = np.arange(275.0, 321.0, 5.0)
SERVE_P = np.round(np.arange(0.85, 1.051, 0.05), 2)
SERVE_NODE = (300.0, 0.95)
SERVE_MEMBERS = 4
SERVE_NODE_BOUND = 2e-6
SERVE_F64_BOUND = 1e-6
SERVE_F64_BAND = (690.0, 1410.0)


def serving_sub_band(store_m, iso, args, X, TT, PP, Tt, Pt, K, m, card):
    """Molecule ``m``'s lattice rows ``K`` (50, nX) on the XS_SUB
    sub-band: the sub-band's lattice on the same lines and states, coarse-
    far and classic, each K1 pass against its plain version (K1's XS
    bounds), and the rows within the coarse-far bound of the classic
    lattice."""
    Xs = arange_drift_free(*XS_SUB)
    lo = int(round((Xs[0] - X[0]) / args.dv))
    check(np.allclose(X[lo:lo + Xs.size], Xs, rtol=0.0, atol=1e-6),
          "the sub-band is not on the lattice's axis")
    fns = {far: make_xsect_fn(store_m, iso, Xs, TT, PP, profile="sdvoigt",
                              wing_abs=XS_WING, wing_hw=args.wing_hw,
                              far_method=far)
           for far in ("auto", "classic")}
    check(len(fns["auto"].corr_calls) > 0, f"molecule {m}: the sub-band "
          "lattice did not take the coarse-far route")
    for far, fn in fns.items():
        check_xs_passes(f"molecule {m} {far}", fn, fn.line_params(Tt, Pt),
                        fn.all_calls(), card, tag="13 serving")
    rel = rel_peak(K[:, lo:lo + Xs.size], fns["classic"](Tt, Pt))
    print(f"[13 serving] molecule {m}: the lattice's {TT.size} rows on "
          f"{XS_SUB[0]:g}-{XS_SUB[1]:g} cm^-1 vs the sub-band's classic "
          f"lattice {rel:.3e} of peak [{card}]", flush=True)
    check(rel <= COARSE_BOUND["sdvoigt"], f"molecule {m}: rows vs the "
          f"classic sub-band lattice {rel:.3e} > {COARSE_BOUND['sdvoigt']}")


def phase_serving(dev, card):
    """13: the lattice (K1's XS modes) for each molecule, its 100 rows
    through AFIT_XS files into ``xs_table_from_files``, ``od_from_xs`` on
    phase 5's members and K2 on the served OD; returns the launches of the
    K1 modes and of K2 on this path."""
    f32 = torch.float32
    args = xs_args(XS_CLI)
    X = arange_drift_free(args.numin, args.numax, args.dv)
    store = synthetic_lines(args.synthetic, nu_min=args.numin - XS_WING,
                            nu_max=args.numax + XS_WING, seed=args.seed,
                            device=dev, dtype=f32)
    iso = IsoTables.load(device=dev)
    TT, PP = (a.ravel() for a in np.meshgrid(SERVE_T, SERVE_P,
                                             indexing="ij"))
    Tt, Pt = (torch.as_tensor(a, dtype=f32, device=dev) for a in (TT, PP))
    fns, rows, build_s, lattice_ms = {}, {}, {}, {}
    reset_launches()
    for m in SERVE_MOLS:
        t0 = time.perf_counter()
        fns[m] = make_xsect_fn(store.select_molecules([m]), iso, X, TT, PP,
                               profile="sdvoigt", wing_abs=XS_WING,
                               wing_hw=args.wing_hw)
        build_s[m] = time.perf_counter() - t0
        rows[m] = fns[m](Tt, Pt)
    torch.cuda.synchronize()
    launches = fast_path(read_launches(), "13 serving lattice")
    print(f"[13 serving] lattice launches (both molecules): "
          f"{ {k: v for k, v in launches.items() if v} }", flush=True)
    for k in ("sdvoigt_asym", "corr:64:sdvoigt", "sdvoigt_core"):
        check(launches[k] > 0, f"kernel {k} was not launched by the "
              "serving lattice")
    for m in SERVE_MOLS:
        lattice_ms[m], again = cuda_ms(lambda: fns[m](Tt, Pt), 2)
        check(torch.equal(again, rows[m]), f"lattice of molecule {m}: two "
              "runs differ")
        K = rows[m]
        check(K.shape == (TT.size, X.size) and bool(torch.isfinite(K).all())
              and K.max().item() > 0.0, f"lattice of molecule {m}")
        print(f"[13 serving] molecule {m}: {TT.size} states x {X.size} "
              f"points (max {K.max().item():.4e} cm^2/molec); plan build "
              f"{build_s[m]:.3f} s, lattice {lattice_ms[m]:.3f} ms (CUDA "
              f"events, warm) [{card}]", flush=True)
        serving_sub_band(store.select_molecules([m]), iso, args, X, TT, PP,
                         Tt, Pt, K, m, card)
    del fns, again

    # the 100 rows through AFIT_XS files and back
    with tempfile.TemporaryDirectory() as tmp:
        paths, nbytes = {}, 0
        t0 = time.perf_counter()
        for m in SERVE_MOLS:
            K = rows[m].cpu().numpy()
            paths[m] = []
            for i, (T, p) in enumerate(zip(TT, PP)):
                path = os.path.join(tmp, f"XS-{m:02d}-{i:02d}.bin")
                xs_write(X, K[i], float(T), float(p) * PA_PER_ATM, m,
                         "radtxfr_tpu synthetic", fname=path)
                paths[m].append(path)
                nbytes += os.path.getsize(path)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        table = xs_table_from_files(paths, device=dev)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
    n_m, n_t, n_p, n_x = table.sigma.shape
    check(table.mol_ids == SERVE_MOLS and (n_t, n_p, n_x)
          == (SERVE_T.size, SERVE_P.size, X.size), "table shape")
    for im, m in enumerate(SERVE_MOLS):
        check(torch.equal(table.sigma[im].reshape(TT.size, n_x), rows[m]),
              f"molecule {m}: the table read from the files is not the "
              "kernel's rows")
    print(f"[13 serving] {n_m * n_t * n_p} AFIT_XS files, {nbytes} B, "
          f"written in {write_s:.3f} s, read into the table on the card in "
          f"{read_s:.3f} s; the table ({table.sigma.numel() * 4} B float32) "
          "equals the kernel's rows bit for bit", flush=True)

    # at a lattice node: the column times the kernel's row
    base = std_atmosphere(device=dev)
    one = lambda v: torch.full((1,), v, dtype=f32, device=dev)
    T0, p0 = SERVE_NODE
    node = dataclasses.replace(base, T=one(T0), p=one(p0 * PA_PER_ATM),
                               pl=one(1.0), z0=base.z0[:1], z1=base.z1[:1],
                               vmr=base.vmr[:1])
    got = od_from_xs(table, node)
    k = int(np.nonzero((TT == T0) & (PP == p0))[0][0])
    want = sum(species_column(node.p.double(), node.T.double(),
                              node.pl.double(),
                              node.vmr[:, base.mol_ids.index(m)].double())
               * rows[m][k].double() for m in SERVE_MOLS)
    rel = rel_peak(got[0].double(), want)
    print(f"[13 serving] at the node (T {T0} K, p {p0} atm): served OD "
          f"vs the column times the kernel's row {rel:.3e} of peak",
          flush=True)
    check(rel <= SERVE_NODE_BOUND, f"node: {rel:.3e} > {SERVE_NODE_BOUND}")

    # phase 5's members: od_from_xs, then K2
    states = members(base, SERVE_MEMBERS)
    grid = torch.as_tensor(X, dtype=f32, device=dev)
    tud_fn = make_tud_fn(base.z0.cpu().numpy(), ALTITUDES, n_angles=30,
                         device=dev)
    lo, hi = np.searchsorted(X, SERVE_F64_BAND[0]), \
        np.searchsorted(X, SERVE_F64_BAND[1], side="right")
    host = XsTable.from_numpy(table.sigma[..., lo:hi].cpu().numpy(),
                              table.T_grid.cpu().numpy(),
                              table.logp_grid.cpu().numpy(), table.x[lo:hi],
                              table.mol_ids, device="cpu",
                              dtype=torch.float64)
    reset_launches()
    err64, err_k2 = 0.0, {"tau": 0.0, "Lu": 0.0, "Ld": 0.0}
    for s in states:
        od = od_from_xs(table, s)
        tud = tud_fn(grid, od, s.T)
        s64 = dataclasses.replace(s, **{f: getattr(s, f).double().cpu()
                                        for f in ("z0", "z1", "pl", "p", "T",
                                                  "vmr")})
        err64 = max(err64, rel_peak(od[:, lo:hi].double().cpu(),
                                    od_from_xs(host, s64)))
        B = planckian(grid, s.T).transpose(0, 1).to(f32)
        ref = tud_from_od(grid, od, B, base.z0, ALTITUDES, n_angles=30)
        for prod in err_k2:
            err_k2[prod] = max(err_k2[prod], rel_peak(getattr(tud, prod),
                                                      getattr(ref, prod)))
        tau, Lu, Ld = tud.tau, tud.Lu, tud.Ld
        check(bool(torch.isfinite(od).all() & torch.isfinite(tau).all()
                   & torch.isfinite(Lu).all() & torch.isfinite(Ld).all()),
              "served products not finite")
        check(tau.min().item() >= 0.0 and tau.max().item() <= 1.0,
              f"tau outside [0, 1]: [{tau.min().item()}, "
              f"{tau.max().item()}]")
        check(Lu.min().item() > 0.0 and Ld.min().item() > 0.0,
              "La and Ld must be positive")
        del ref, B
    torch.cuda.synchronize()
    serve_launches = fast_path(read_launches(), "13 served members")
    print(f"[13 serving] {SERVE_MEMBERS} members x {X.size} points: "
          f"launches {dict((k, v) for k, v in serve_launches.items() if v)}"
          f"; the card's float32 OD vs the CPU's float64 od_from_xs on "
          f"{SERVE_F64_BAND[0]:g}-{SERVE_F64_BAND[1]:g} cm^-1 {err64:.3e} "
          f"of peak; K2 vs tud_from_od on the served OD: "
          + ", ".join(f"{k} {v:.3e}" for k, v in err_k2.items())
          + " of peak", flush=True)
    check(serve_launches["tud"] == SERVE_MEMBERS, "K2 was not launched once "
          "a served member")
    check(err64 <= SERVE_F64_BOUND, f"served OD vs float64: "
          f"{err64:.3e} > {SERVE_F64_BOUND}")
    for prod, e in err_k2.items():
        check(e <= K2_BOUND, f"K2 {prod} on the served OD: {e:.3e} > "
              f"{K2_BOUND}")

    s = states[0]
    od_ms, od = cuda_ms(lambda: od_from_xs(table, s), 10)
    dflt_ms, od_d = cuda_ms(lambda: od_from_xs(table, s,
                                               precision="default"), 10)
    rel_d = rel_peak(od_d, od)
    k2_ms, _ = cuda_ms(lambda: tud_fn(grid, od, s.T), 5)
    t0 = time.perf_counter()
    tud = tud_fn(grid, od_from_xs(table, s), s.T)
    torch.cuda.synchronize()
    member_s = time.perf_counter() - t0
    n_l, n_k = base.n_layers, n_m * n_t * n_p
    od_bytes = 4 * (n_k * n_x + n_l * n_k + n_l * n_x)
    od_flops = 2 * n_l * n_k * n_x
    b_ms, b_by = bound(od_flops, od_bytes)
    print(f"[13 serving] od_from_xs (one member, {n_l} x {n_k} @ {n_k} x "
          f"{n_x}): {od_ms:.4f} ms 'highest' (TF32 off), {dflt_ms:.4f} ms "
          f"'default' (TF32; {rel_d:.3e} of peak from 'highest'; CUDA "
          f"events, warm); {od_bytes} B and {od_flops:.4g} FLOP: bound "
          f"{b_ms:.4f} ms ({b_by}; bytes "
          f"{od_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms at "
          f"{HBM_BYTES_PER_S:.4g} B/s, FLOP "
          f"{od_flops / FP32_OPS_PER_S * 1e3:.4f} ms at "
          f"{FP32_OPS_PER_S:.4g}/s); K2 {k2_ms:.4f} ms; a served member "
          f"(od_from_xs + K2) {member_s:.4f} s wall [{card}]", flush=True)
    del table, host, rows, od, od_d, tud
    torch.cuda.empty_cache()
    return {**{k: launches[k] for k in ("sdvoigt_asym", "corr:64:sdvoigt",
                                        "sdvoigt_core")},
            "tud": serve_launches["tud"]}


# phase 14: each ported example as a child process on the card
EXAMPLES = ("01_od_tud_quickstart.py", "02_production_tud_ensemble.py",
            "03_hapi_dropin.py", "04_xs_lattice_serving.py",
            "05_derived_physics.py")
EXAMPLE_TIMEOUT = 240


def phase_examples(card):
    here = os.path.dirname(os.path.abspath(__file__))
    for name in EXAMPLES:
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            r = subprocess.run([sys.executable, os.path.join(
                here, "examples", "torch", name)], cwd=tmp,
                capture_output=True, text=True, timeout=EXAMPLE_TIMEOUT)
            wall = time.perf_counter() - t0
        lines = r.stdout.strip().splitlines()
        check(r.returncode == 0 and lines and lines[-1] == "OK",
              f"example {name} failed ({r.returncode}):\n{r.stdout[-3000:]}"
              f"\n{r.stderr[-3000:]}")
        print(f"[14 examples] {name} on the card: OK in {wall:.2f} s wall; "
              f"{lines[-2] if len(lines) > 1 else ''} [{card}]", flush=True)


# phase 15: the hapi drop-in (hapi_compat) and the reference-signature
# layer (compat). (a) compat.compute_TUD on the kernels at the production
# width, bit-identical to the direct route; (b) compat.compute_OD on the
# reference engine, card against CPU (float64); (c) the reference
# generator's hapi call (misc/RT_gen_AbsXS_files.py:87-92) on the XS_CLI
# list, cut to 1000-1010 cm^-1, at its corner states, and the other four
# drivers once, card against CPU (float64; SD-Voigt and HT at pcqsdhc's
# cancellation bound); (d) the spectra and the seven slits on (c)'s output
HAPI_BAND = (1000.0, 1010.0)
HAPI_STEP = 0.0025
HAPI_T = (275.0, 320.0)
HAPI_P = (0.85, 1.05)
HAPI_MOLS = (1, 2)
#: the SD-Voigt states also run on the CPU (its reference engine takes
#: seconds a call there): one corner a molecule
HAPI_CPU_STATES = ((1, 275.0, 0.85), (2, 320.0, 1.05))
HAPI_SD_BOUND = 1e-7       # pcqsdhc: up to 1.6e-8 of peak an ulp (ROADMAP)
HAPI_BOUND = 1e-10
SPECTRA_BOUND = 1e-12
COMPAT_OD = dict(DVOUT=0.0025, T=280.0, P=90000.0, PL=1.0,
                 MF_ID=np.array([1, 2, 3]),
                 MF_VAL=np.array([10000.0, 400.0, 0.05]), continuum="mt_ckd")
HAPI_SLIT_NAMES = ("SLIT_RECTANGULAR", "SLIT_TRIANGULAR", "SLIT_GAUSSIAN",
                   "SLIT_DISPERSION", "SLIT_COSINUS", "SLIT_DIFFRACTION",
                   "SLIT_MICHELSON")


def save_sd_table(store, directory, name):
    """``save_table``'s hapi table of ``store`` with an ``SD_air`` column
    appended (the column hapi's 'sdvoigt' parameter group fetches; the
    standard ``.data`` columns carry none, so the drivers would see 0)."""
    data = save_table(store, directory, name)
    header_path = os.path.splitext(data)[0] + ".header"
    with open(data) as f:
        rows = f.read().splitlines()
    with open(data, "w") as f:
        for row, sd in zip(rows, store.host["sd_air"]):
            f.write(row + "%9.6f" % sd + "\n")
    with open(header_path) as f:
        header = json.load(f)
    header["order"].append("SD_air")
    header["format"]["SD_air"] = "%9.6f"
    header["default"]["SD_air"] = 0
    header["size_in_bytes"] = os.path.getsize(data)
    with open(header_path, "w") as f:
        json.dump(header, f, indent=2)


def hapi_on(where, directory, calls):
    """Open ``directory`` with ``hapi_compat.db_begin`` on ``where`` and run
    ``calls`` ((label, driver name, kwargs) ...): {label: (nu, k, s)}."""
    for reg in (hc._TABLES, hc._EXTRAS, hc._META):
        reg.clear()
    hc.db_begin(directory, device=where)
    out = {}
    for label, name, kw in calls:
        t0 = time.perf_counter()
        nu, k = getattr(hc, name)(**kw)
        out[label] = (nu, k, time.perf_counter() - t0)
    return out


def phase_hapi(dev, card):
    """15: the hapi drop-in and compat (see HAPI_* above); returns the K1
    launches of compat.compute_TUD by mode."""
    f32, f64, cpu = torch.float32, torch.float64, torch.device("cpu")
    # (a) the reference-signature TUD on the kernels at the production width
    lines = derived_lwir_linelist(FULL_BAND[0] - MARGIN,
                                  FULL_BAND[1] + MARGIN, device=dev,
                                  dtype=f32)
    kw = dict(lines=lines, engine="pallas", continuum="mt_ckd",
              DVOUT=FULL_BAND[2])
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_launches()
    X, tau, Lu, Ld = rt.compute_TUD(FULL_BAND[0], FULL_BAND[1], **kw)
    torch.cuda.synchronize()
    launches = fast_path(read_launches(), "15 compat.compute_TUD")
    peak = torch.cuda.max_memory_allocated(dev)
    print(f"[15a compat] compute_TUD({FULL_BAND[0]:g}, {FULL_BAND[1]:g}, "
          f"engine='pallas', continuum='mt_ckd', DVOUT {FULL_BAND[2]:g}): "
          f"{X.size} points, 66 layers, Altitudes [500], N_angle 30; "
          f"launches {dict((k, v) for k, v in launches.items() if v)}; "
          f"peak device memory {peak / 2**30:.3f} GiB", flush=True)
    for k in ("asym", "core"):
        check(launches[k] > 0, f"compat.compute_TUD did not launch K1 {k}")
    check(launches["tud"] == 0, "compat.compute_TUD composes in plain torch")
    check(tau.shape == Lu.shape == Ld.shape == X.shape, "compat shapes")
    for name, a in (("tau", tau), ("Lu", Lu), ("Ld", Ld)):
        check(np.isfinite(a).all(), f"compat {name} not finite")
    check(tau.min() >= 0.0 and tau.max() <= 1.0,
          f"compat tau outside [0, 1]: [{tau.min()}, {tau.max()}]")
    check(Lu.min() > 0.0 and Ld.min() > 0.0, "compat Lu and Ld must be > 0")
    t0 = time.perf_counter()
    again = rt.compute_TUD(FULL_BAND[0], FULL_BAND[1], **kw)
    compat_s = time.perf_counter() - t0
    # the same inputs through the port's own route
    o = rt.DEFAULT_OPTIONS
    atm = AtmosphericState.from_numpy(
        z0=o["Zs"], z1=o["Zs"], pl=o["PLs"], p=o["Ps"], T=o["Ts"],
        vmr=np.asarray(o["MFs_VAL"], dtype=np.float64) * 1e-6,
        mol_ids=tuple(int(m) for m in o["MFs_ID"]), device=dev, dtype=f32)
    iso = IsoTables.load(device=dev)
    t0 = time.perf_counter()
    od = compute_od_layers(lines, iso, X, atm, engine="pallas",
                           continuum="mt_ckd")
    B = planckian(torch.as_tensor(X, device=dev),
                  atm.T.double()).transpose(0, 1).to(f32)
    ref = tud_from_od(torch.as_tensor(X, dtype=f32, device=dev), od, B,
                      atm.z0, torch.tensor([500.0], dtype=f32, device=dev),
                      mu=1.0, n_angles=30).squeezed()
    ref = [a.cpu().numpy() for a in (ref.tau, ref.Lu, ref.Ld)]
    direct_s = time.perf_counter() - t0
    same = all(np.array_equal(a, b) for a, b in zip((tau, Lu, Ld), ref))
    same_again = all(np.array_equal(a, b)
                     for a, b in zip((tau, Lu, Ld), again[1:]))
    print(f"[15a compat] tau in [{tau.min():.4g}, {tau.max():.4g}], Lu in "
          f"[{Lu.min():.4g}, {Lu.max():.4g}], Ld in [{Ld.min():.4g}, "
          f"{Ld.max():.4g}]; bit-identical to compute_od_layers(engine="
          f"'pallas') + tud_from_od: {same}; to a second call: "
          f"{same_again}; warm wall {compat_s:.3f} s a call (plans built "
          f"each call), the direct route {direct_s:.3f} s [{card}]",
          flush=True)
    check(same, "compat.compute_TUD differs from the direct route")
    check(same_again, "two compat.compute_TUD calls differ")
    del lines, od, B, ref, again, tau, Lu, Ld
    torch.cuda.empty_cache()

    # (b) compat.compute_OD on the reference engine, float64
    out = []
    for where in (dev, cpu, dev):           # the card's second call warm
        lines64 = derived_lwir_linelist(HAPI_BAND[0] - MARGIN,
                                        HAPI_BAND[1] + MARGIN,
                                        device=where, dtype=f64)
        t0 = time.perf_counter()
        Xo, od = rt.compute_OD(*HAPI_BAND, lines=lines64, **COMPAT_OD)
        out.append((od, time.perf_counter() - t0))
    out = {"card": out[2], "cpu": out[1]}
    rel = np.abs(out["card"][0] - out["cpu"][0]).max() / \
        np.abs(out["cpu"][0]).max()
    print(f"[15b compat] compute_OD({HAPI_BAND[0]:g}, {HAPI_BAND[1]:g}, "
          f"engine='jnp', float64, {Xo.size} points, {lines64.n_lines} "
          f"lines): card vs CPU {rel:.3e} of peak; {out['card'][1]:.3f} s "
          f"(warm) on the card, {out['cpu'][1]:.3f} s on the CPU [{card}]",
          flush=True)
    check(rel <= HAPI_BOUND, f"compute_OD card vs CPU {rel:.3e} > "
          f"{HAPI_BOUND}")

    # (c) the reference generator's hapi call, spelled in hapi names
    args = xs_args(XS_CLI)
    store = synthetic_lines(args.synthetic, nu_min=args.numin - XS_WING,
                            nu_max=args.numax + XS_WING, seed=args.seed,
                            device="cpu", dtype=f64)
    base = dict(SourceTables="XS_CLI", OmegaStep=HAPI_STEP,
                OmegaRange=HAPI_BAND, OmegaWing=XS_WING, HITRAN_units=True)
    calls = [((m, T, p), "absorptionCoefficient_SDVoigt",
              dict(Components=[(m, 1)], Environment={"T": T, "p": p},
                   **base))
             for m in HAPI_MOLS for T in HAPI_T for p in HAPI_P]
    one = dict(Components=[(1, 1)], Environment={"T": HAPI_T[0],
                                                 "p": HAPI_P[0]}, **base)
    calls += [(name, f"absorptionCoefficient_{name}", one)
              for name in ("Voigt", "Lorentz", "Doppler", "HT")]
    with tempfile.TemporaryDirectory() as tmp:
        save_sd_table(store, tmp, "XS_CLI")
        res = {"card": hapi_on(dev, tmp, calls),
               "cpu": hapi_on(cpu, tmp, [
                   c for c in calls if not isinstance(c[0], tuple)
                   or c[0] in HAPI_CPU_STATES])}
        table = hc._get_table("XS_CLI")
    for label, _, _ in calls:
        nu, k, s_c = res["card"][label]
        what = (f"SDVoigt molecule {label[0]} T {label[1]:g} K p "
                f"{label[2]:g} atm" if isinstance(label, tuple) else label)
        check(nu.size == 4001 and np.isfinite(k).all() and k.max() > 0.0,
              f"{what}: k")
        if label not in res["cpu"]:
            print(f"[15c hapi] {what}: {s_c:.3f} s on the card [{card}]",
                  flush=True)
            continue
        nu_h, k_h, s_h = res["cpu"][label]
        check(np.array_equal(nu, nu_h), "driver axes")
        rel = np.abs(k - k_h).max() / np.abs(k_h).max()
        bound = (HAPI_BOUND if label in ("Voigt", "Lorentz", "Doppler")
                 else HAPI_SD_BOUND)
        print(f"[15c hapi] {what}: card vs CPU {rel:.3e} of peak (bound "
              f"{bound:g}); {s_c:.3f} s on the card, {s_h:.3f} s on the "
              f"CPU [{card}]", flush=True)
        check(rel <= bound, f"{what}: {rel:.3e} > {bound}")
    # the gap to run_xsect's K1 lattice on the same lines at the same states
    lat_lines = LineStore.from_numpy(**table.host, device=dev, dtype=f32)
    iso = IsoTables.load(device=dev)
    Xs = arange_drift_free(HAPI_BAND[0], HAPI_BAND[1], HAPI_STEP)
    TT, PP = (a.ravel() for a in np.meshgrid(HAPI_T, HAPI_P,
                                             indexing="ij"))
    for m in HAPI_MOLS:
        fn = make_xsect_fn(lat_lines.select_molecules([m]), iso, Xs, TT, PP,
                           profile="sdvoigt", wing_abs=XS_WING,
                           wing_hw=args.wing_hw)
        K = fn(torch.as_tensor(TT, dtype=f32, device=dev),
               torch.as_tensor(PP, dtype=f32, device=dev)).cpu().numpy()
        gaps = [np.abs(K[i] - res["card"][(m, T, p)][1]).max()
                / np.abs(res["card"][(m, T, p)][1]).max()
                for i, (T, p) in enumerate(zip(TT, PP))]
        print(f"[15c hapi] molecule {m}: the K1 lattice (make_xsect_fn, "
              f"float32, coarse-far) vs the driver at the 4 states: "
              + ", ".join(f"{g:.3e}" for g in gaps) + " of peak (no bound)",
              flush=True)

    # (d) spectra and the seven slits on (c)'s output, card against CPU
    T0, p0 = HAPI_T[0], HAPI_P[0]
    nu, k, _ = res["card"][(1, T0, p0)]
    k_cm = k * hc.volumeConcentration(p0, T0)
    spec = {}
    t0 = time.perf_counter()
    for label, where in (("card", dev), ("cpu", cpu)):
        nu_t = torch.as_tensor(nu, device=where)
        _, rad = hc.radianceSpectrum(nu_t, torch.as_tensor(k_cm, device=where),
                                     Environment={"T": T0, "l": 100.0})
        spec[label] = {"radiance": rad}
        for slit in HAPI_SLIT_NAMES:
            spec[label][slit] = hc.convolveSpectrum(
                nu_t, torch.as_tensor(rad, device=where), Resolution=0.1,
                AF_wing=1.0, SlitFunction=getattr(hc, slit))[1]
    spec_s = time.perf_counter() - t0
    errs = {}
    for key, want in spec["cpu"].items():
        got = spec["card"][key]
        check(isinstance(got, np.ndarray) and got.shape == want.shape
              and np.isfinite(got).all(), f"{key} shape")
        errs[key] = np.abs(got - want).max() / np.abs(want).max()
    print(f"[15d spectra] radianceSpectrum and convolveSpectrum (Resolution "
          f"0.1, AF_wing 1.0) with each slit, card vs CPU: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
          + f" of peak; both devices {spec_s:.3f} s [{card}]", flush=True)
    for key, e in errs.items():
        check(e <= SPECTRA_BOUND, f"{key}: card vs CPU {e:.3e} > "
              f"{SPECTRA_BOUND}")
    for reg in (hc._TABLES, hc._EXTRAS, hc._META):
        reg.clear()
    hc._DEVICE = None
    torch.cuda.empty_cache()
    return {k: launches[k] for k in ("asym", "core")}


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
    k1, k1_ieee = run(phase_k1, dev, card)
    k1d, k1d_ieee = run(phase_k1_diff, dev, card)
    xs_stats, full_launches, xs_ieee = run(phase_xs_sub, dev, card)
    ht_stats, ht_ieee = run(phase_ht_sub, dev, card)
    k7, k7_launches = run(phase_unfused_sub, dev, card)
    k2 = run(phase_k2, dev, card)
    launches, x_lo, products = run(phase_main, card)
    run(phase_scene, card, launches, x_lo, products)
    run(phase_checkpoint, card)
    run(phase_jnp, dev, card)
    jac_launches = run(phase_jacobian, card)
    xs_launches = {**run(phase_xs_main, dev, card),
                   **{m: full_launches[fk(m)]
                      for m in ("corr:64:voigtfull", "corr:64:sdvoigtfull")}}
    ht_launches = run(phase_ht_lattice, dev, card)
    run(phase_ht_layered, dev, card)
    ht_jac_launches = run(phase_ht_jacobian, dev, card)
    run(phase_sdvoigt_jacobian, dev, card)
    k7_full, route_launches = run(phase_od_layers, dev, card)
    k7.update(k7_full)
    sharded = run(phase_sharded, dev, card, x_lo, products)
    span = run(phase_span, card, sharded)
    serving = run(phase_serving, dev, card)
    run(phase_examples, card)
    compat = run(phase_hapi, dev, card)
    run(phase_breakdown, dev, card)
    run(phase_jac_breakdown, dev, card)
    run(phase_xs_breakdown, dev, card)
    run(phase_ht_breakdown, dev, card)
    src = "radtxfr_tpu_torch/csrc/"
    xs = "radtxfr_tpu/kernels/pallas_xsect.py:"

    def pair(name, source, line, key, fast_n, fast_path, ieee_n, ieee_path,
             stats):
        """A kernel's FAST entry (``<name>_fast``: the main path's, the
        builders' default fast_rcp=True) and its IEEE entry (``name``:
        fast_rcp=False, on the path named), each with its phase-3 numbers
        (``stats`` keyed by ``key`` and ``fk(key)``)."""
        cu = src + source + ".cu"
        return [{"name": f"{name}_fast", "route": "cuda",
                 "source": src + source + "_fast.cu", "replaces": xs + line,
                 "fast_rcp": True, "launches": fast_n,
                 "launch_path": fast_path, **stats[fk(key)]},
                {"name": name, "route": "cuda", "source": cu,
                 "replaces": xs + line, "fast_rcp": False,
                 "launches": ieee_n, "launch_path": ieee_path,
                 **stats[key]}]

    sub3 = "make_od_fn(fast_rcp=False) on phase 3's sub-band"
    kernels = []
    for m in PRODUCTION_MODES:
        kernels += pair(f"fused_xsect_{m}", "fused_xsect", "710", m,
                        launches[m], "phase 5 run_tud (production)",
                        k1_ieee[m], sub3, k1)
    kernels += pair("fused_xsect_full", "fused_xsect", "710", "full",
                    jac_launches["full"], "phase 5b run_tud --jacobian",
                    k1d_ieee["full"], "jvp of make_od_fn(differentiable="
                    "True, fast_rcp=False) on phase 3b's sub-band", k1d)
    kernels += pair("fused_xsect_jvp", "fused_xsect_jvp", "1212", "jvp",
                    jac_launches["jvp"], "phase 5b run_tud --jacobian",
                    k1d_ieee["jvp"], "jvp of make_od_fn(differentiable="
                    "True, fast_rcp=False) on phase 3b's sub-band", k1d)
    for m in XS_MODES:
        kernels += pair(f"fused_xsect_{m}", "fused_xsect", "710", m,
                        xs_launches[m], "phase 7 (xsect CLI, bench, "
                        "single-pass lattices; *full: direct runs)",
                        xs_ieee[m], "make_xsect_fn(fast_rcp=False) on phase "
                        "3c's sub-band (*full: direct runs)", xs_stats)
    kernels += pair("fused_ht", "fused_ht", "929", "ht", ht_launches["ht"],
                    "phase 9 HT lattice", ht_ieee["ht"],
                    "make_ht_fn and a jvp of make_od_ht_fn(differentiable="
                    "True), both fast_rcp=False, on phase 3d's sub-band",
                    ht_stats)
    kernels.append({"name": "fused_ht_jvp", "route": "cuda",
                    "source": src + "fused_ht.cu", "replaces": xs + "1058",
                    "fast_rcp": False,
                    "launches": ht_jac_launches["ht_jvp"],
                    "launch_path": "phase 9c HT Jacobian",
                    **ht_stats["ht_jvp"]})
    kernels += pair("fused_xsect_sdvoigt_jvp", "fused_xsect_jvp", "1324",
                    "sdvoigt_jvp", ht_jac_launches["sdvoigt_jvp"],
                    "phase 9c HT Jacobian", ht_ieee["sdvoigt_jvp"],
                    "jvp of make_od_ht_fn(differentiable=True, fast_rcp="
                    "False) on phase 3d's sub-band", ht_stats)
    for m in K7_MODES:
        k = f"unfused_{m}"
        full = m == "full"
        kernels += pair(
            f"unfused_xsect_{m}", "fused_xsect", "659", m,
            (route_launches if full else k7_launches)[fk(k)],
            "phase 11 compute_od_layers(plan=..., pallas_opts={'fast_rcp': "
            "True})" if full else "phase 3e direct launch",
            (route_launches if full else k7_launches)[k],
            "phase 11 compute_od_layers(plan=...) (its default, as JAX's "
            "xsect_pallas)" if full else "phase 3e direct launch", k7)
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
    # the tangent mode (the Jacobians' composition): no TPU kernel, JAX
    # differentiates its scan composition; its numbers are phase 4's, its
    # launches the sharded Jacobian's (phase 12) and the CLI's (phase 5b)
    kernels.append({"name": "fused_tud_jvp", "route": "cuda",
                    "source": src + "fused_tud.cu",
                    "replaces": "jvp of radtxfr_tpu/products/tud.py:"
                                "tud_from_od", **k2["tud_jvp"],
                    "launches": sharded["jacobian_launches"]["tud_jvp"],
                    "launch_path": "phase 12 sharded Jacobian "
                                   "(make_tud_jacobian_fn)",
                    "cli_launches": jac_launches["tud_jvp"],
                    "cli_path": "phase 5b run_tud --jacobian"})

    def path_key(entry):
        """The kernel key of an entry that the fast_rcp=True paths below
        (phases 12, 13, 15, 16) launch: a FAST entry's, or one without a
        FAST instantiation; None for an IEEE entry."""
        if entry.get("fast_rcp") is False and entry["name"] != "fused_ht_jvp":
            return None
        return entry["name"].replace("fused_xsect_", "", 1).replace(
            "fused_tud", "tud").removesuffix("_fast")

    # the launches with per-tile grid offsets (phase 12): K1's production
    # modes in the sharded ensemble, K1 full and K3 in the sharded Jacobian,
    # K4 (and K3) in the sharded SD-Voigt tangents
    for entry in kernels:
        key = path_key(entry)
        for path in ("ensemble", "jacobian", "sdvoigt"):
            if key and sharded[path].get(key):
                entry["offset_launches"] = sharded[path][key]
                entry["offset_path"] = f"phase 12 sharded {path}"
                break
    # the launches in each of phase 16's two processes (the weighted
    # ensemble's, the Jacobian's)
    for entry in kernels:
        key = path_key(entry)
        if key in span and entry["name"] != "fused_tud_source_input":
            entry["span_launches"] = span[key]
            entry["span_path"] = "phase 16 mesh over two processes"
    # the launches of the serving path (phase 13): K1's lattice modes and
    # K2 on the served OD
    for entry in kernels:
        key = path_key(entry)
        if key in serving and entry["name"] != "fused_tud_source_input":
            entry["serving_launches"] = serving[key]
            entry["serving_path"] = "phase 13 serving"
    # the launches of compat.compute_TUD (phase 15): K1 asym and core
    for entry in kernels:
        key = path_key(entry)
        if entry["name"].startswith("fused_xsect_") and key in compat:
            entry["compat_launches"] = compat[key]
            entry["compat_path"] = "phase 15 compat.compute_TUD"
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
