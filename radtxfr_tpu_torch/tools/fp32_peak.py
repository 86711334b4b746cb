"""The card's FP32 issue rate, measured (P1 and P2).

Counterpart of the JAX package's VPU-peak probes, ``bench.py::
measured_vpu_peak`` (P1: a dependent ``a*y+b`` chain counted as 2 ops a
step and a ``y*a`` chain counted as 1, the peak the larger rate) and
``tools/vpu_peak_probe.py`` (P2: the instruction-mix suite). On the H100
the chains run in the kernel of ``csrc/peak_probe.cu``: one thread per
element, enough CTAs for every SM's full thread count, the chains in
registers, each step one intrinsic (nothing contracted or folded), timed
by CUDA events, best of 5. The measured peak is the denominator that
``chip_smoke.py`` states every kernel's bound against beside the data
sheet's 67 TFLOP/s. On the H100 P1's two chains alone do not reach it: one
dependent FFMA chain a thread issues at half the pipe's rate even at full
occupancy (33.3 against 66.2 TFLOP/s for four independent chains; NVIDIA
H100 80GB HBM3, 700 W), so the peak also takes the suite's four-chain FMA
mix, the one that exposes the pipe's rate, as P2's suite validates P1's
figure there. A rate above 1.05 x 67 TFLOP/s can only mean that a chain
was folded: the probe then raises instead of reporting it.

    python -m radtxfr_tpu_torch.tools.fp32_peak    # on a machine with a card

prints one JSON line per mix (``ops_per_s``: steps a second, an FMA one
step; ``flops_per_s``: an FMA 2) and the measured peak. :func:`probe`
launches the kernel for CUDA tensors and runs :func:`probe_plain`, the same
chains step by step in PyTorch, for CPU tensors.
"""

from __future__ import annotations

import collections
import json

import numpy as np
import torch

from .. import _build, resolve_device

__all__ = ["OPS", "FLOPS_PER_STEP", "SUITE", "PEAK_MIXES", "LAUNCHES",
           "CHECK_A", "CHECK_B",
           "probe", "probe_plain", "measured_fp32_peak", "probe_suite",
           "main"]

#: the operations, in the CUDA switch's order: a*y + b, y*a, y + b,
#: (y + b)*a
OPS = ("fma", "mul", "add", "addmul")
#: flops a step counts (P1 counts the FMA step as 2 ops, bench.py:160)
FLOPS_PER_STEP = {"fma": 2, "mul": 1, "add": 1, "addmul": 2}
#: the suite's mixes (P2's main()): (name, operation, independent chains)
SUITE = (("fma_dep", "fma", 1), ("fma_ilp2", "fma", 2),
         ("fma_ilp4", "fma", 4), ("mul_dep", "mul", 1),
         ("mul_ilp2", "mul", 2), ("add_dep", "add", 1),
         ("addmul_ilp4", "addmul", 4))
#: P1's constants, the timed runs' operands
A, B = np.float32(0.9999999), np.float32(1e-9)
#: the correctness checks' operands: each step moves y in [0.25, 60) by many
#: float32 ulps (P1's b is under half an ulp of y, so that y + b == y), and
#: 0.999^512 stays normal, so a wrong or missing operation shows at every
#: depth
CHECK_A, CHECK_B = np.float32(0.999), np.float32(0.1)
#: NVIDIA H100 SXM data sheet, FP32 outside the tensor cores
DATA_SHEET_FP32 = 67e12
#: above this a chain was folded: the probe raises
FOLD_LIMIT = 1.05 * DATA_SHEET_FP32
#: the timed runs' unrolled depth (csrc: 8 or 256) and steps per chain
DEPTH = 256
STEPS = 2_560_000
#: launches of the probe kernel since the last reset
LAUNCHES = collections.Counter()

_PEAK = {}


def probe_plain(op: str, depth: int, iters: int, y0: torch.Tensor,
                a=A, b=B) -> torch.Tensor:
    """The probe's chains step by step in PyTorch: ``y0`` (n, n_chains)
    float32 chain starts, ``depth * iters`` steps of ``op`` each, then the
    sum of each row's chains in order; (n,) float32. An FMA rounds once,
    so its step is taken in float64 and rounded to float32 (the float64
    sum of the exact float64 product can round differently from the FMA in
    rare ties: a last-place difference)."""
    y = y0.to(torch.float32).clone()
    a32 = torch.tensor(a, dtype=torch.float32)
    b32 = torch.tensor(b, dtype=torch.float32)
    for _ in range(depth * iters):
        if op == "fma":
            y = (a32.double() * y.double() + b32.double()).float()
        elif op == "mul":
            y = y * a32
        elif op == "add":
            y = y + b32
        elif op == "addmul":
            y = (y + b32) * a32
        else:
            raise ValueError(f"op must be one of {OPS}, got {op!r}")
    acc = y[:, 0].clone()
    for k in range(1, y.shape[1]):
        acc = acc + y[:, k]
    return acc


def probe(op: str, depth: int, iters: int, y0: torch.Tensor, a=A,
          b=B) -> torch.Tensor:
    """The probe's chains: (n,) float32 sums of ``y0``'s (n, n_chains)
    chains after ``depth * iters`` steps of ``op``. CPU tensors run
    :func:`probe_plain`. CUDA tensors launch the kernel
    (``csrc/peak_probe.cu``, ``depth`` 8 or 256, ``n_chains`` as the
    suite's mixes) on the current stream; anything it does not take
    raises, as does a non-zero CUDA error from the launch."""
    if y0.device.type == "cpu":
        return probe_plain(op, depth, iters, y0, a, b)
    if op not in OPS:
        raise ValueError(f"op must be one of {OPS}, got {op!r}")
    if y0.dim() != 2:
        raise ValueError("y0 must be (n, n_chains)")
    n, n_chains = y0.shape
    if (op, n_chains) not in {(o, c) for _, o, c in SUITE} or \
            depth not in (8, DEPTH):
        raise ValueError(f"no probe kernel for {op} x {n_chains} chains at "
                         f"depth {depth}")
    _build.check_tensor("y0", y0, torch.float32, y0.device)
    out = torch.empty(n, dtype=torch.float32, device=y0.device)
    err = _build.library().radtxfr_fp32_probe(
        OPS.index(op), n_chains, depth, y0.data_ptr(), float(a), float(b),
        iters, n, out.data_ptr(),
        _build.launch_stream(y0.device))
    if err != 0:
        raise RuntimeError(f"peak probe kernel launch failed with CUDA "
                           f"error {err}")
    LAUNCHES["fp32_peak_probe"] += 1
    return out


def _timed(name: str, op: str, n_chains: int, dev, trials: int = 5):
    """One mix on every SM's full thread count, best of ``trials`` CUDA-event
    timings: its record, with the chains' steps a second."""
    props = torch.cuda.get_device_properties(dev)
    n = props.multi_processor_count * props.max_threads_per_multi_processor
    starts = np.float32(0.5) * (1.0 + 1e-6 * np.arange(n_chains))
    y0 = torch.tensor(np.tile(starts.astype(np.float32), (n, 1)),
                      device=dev)
    iters = STEPS // (DEPTH * n_chains)
    probe(op, DEPTH, iters, y0)                   # warm
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    best = float("inf")
    for _ in range(trials):
        start.record()
        out = probe(op, DEPTH, iters, y0)
        stop.record()
        torch.cuda.synchronize(dev)
        best = min(best, start.elapsed_time(stop))
    if not torch.isfinite(out).all():
        raise RuntimeError(f"{name}: non-finite chain sums")
    steps = n * n_chains * DEPTH * iters
    rec = {"probe": name, "ops_per_s": steps / (best * 1e-3),
           "flops_per_s": steps * FLOPS_PER_STEP[op] / (best * 1e-3),
           "ms": best, "n_chains": n_chains, "depth": DEPTH, "iters": iters,
           "threads": n}
    if rec["flops_per_s"] > FOLD_LIMIT:
        raise RuntimeError(
            f"{name}: {rec['flops_per_s']:.4g} flop/s exceeds 1.05 x the "
            f"data sheet's {DATA_SHEET_FP32:.4g}: the chain was folded")
    return rec


def _card(device):
    dev = resolve_device(device)
    if dev.type != "cuda":
        raise ValueError(f"the FP32 peak is a measurement of the card, not "
                         f"of {dev}")
    return dev


#: the mixes the measured peak is the largest rate of (name, op, chains):
#: P1's dependent FMA (2 ops a step) and multiply (1 op) chains, and the
#: four-chain FMA, which the dependent FFMA chain does not reach on Hopper
PEAK_MIXES = (("fma_dep", "fma", 1), ("mul_dep", "mul", 1),
              ("fma_ilp4", "fma", 4))


def measured_fp32_peak(device=None):
    """The card's measured FP32 issue rate, cached per device: the largest
    rate of :data:`PEAK_MIXES` in ops/s (an FMA 2), with the mix that gave
    it."""
    dev = _card(device)
    key = torch.cuda.get_device_name(dev), dev.index
    if key not in _PEAK:
        rates = {name: _timed(name, op, nch, dev)["flops_per_s"]
                 for name, op, nch in PEAK_MIXES}
        best = max(rates, key=rates.get)
        _PEAK[key] = rates[best], best
    return _PEAK[key]


def probe_suite(device=None) -> list[dict]:
    """P2's instruction mixes (:data:`SUITE`) on the card, one record each:
    ``ops_per_s`` (steps a second), ``flops_per_s`` (an FMA 2), best
    milliseconds, chains, depth, iterations and threads."""
    dev = _card(device)
    return [_timed(name, op, nch, dev) for name, op, nch in SUITE]


def main():
    dev = _card(None)
    print(json.dumps({"device": torch.cuda.get_device_name(dev),
                      "torch": torch.__version__}), flush=True)
    for rec in probe_suite(dev):
        print(json.dumps(rec), flush=True)
    peak, which = measured_fp32_peak(dev)
    print(json.dumps({"peak_ops_per_s": peak, "peak_probe": which,
                      "of_data_sheet": peak / DATA_SHEET_FP32}), flush=True)


if __name__ == "__main__":
    main()
