"""Tracing, profiling and metrics (counterpart of
``radtxfr_tpu/utils/profiling.py``).

* :class:`PhaseTimer`: per-phase wall timing with derived throughput
  (lines/s, nu-points/s, spectra/s) as first-class numbers;
* :func:`trace`: ``torch.profiler`` over the CPU and the card, written for
  TensorBoard;
* :class:`MetricsLog`: append-only JSONL metrics sink.
"""

from __future__ import annotations

import contextlib
import json
import time

import torch

__all__ = ["PhaseTimer", "device_sync", "trace", "MetricsLog"]


def device_sync(x):
    """Wait for the work that produces ``x`` (a tensor, or a nested
    list/tuple/dict/dataclass of them): synchronise the CUDA device of
    every tensor in it, each device once. Returns ``x``."""
    devices = set()

    def walk(v):
        if isinstance(v, torch.Tensor):
            if v.is_cuda:
                devices.add(v.device)
        elif isinstance(v, dict):
            for w in v.values():
                walk(w)
        elif isinstance(v, (list, tuple)):
            for w in v:
                walk(w)
        elif hasattr(v, "__dataclass_fields__"):
            for name in v.__dataclass_fields__:
                walk(getattr(v, name))

    walk(x)
    for d in devices:
        torch.cuda.synchronize(d)
    return x


class PhaseTimer:
    """Accumulates named phase durations and optional work counters."""

    def __init__(self):
        self.phases: dict[str, float] = {}
        self.work: dict[str, float] = {}

    @contextlib.contextmanager
    def phase(self, name: str, work_items: float | None = None,
              block_on=None):
        """Time the ``with`` block under ``name``; ``block_on`` (tensors,
        see :func:`device_sync`) is waited for before the clock stops, so
        a phase that launches work on the card is charged its run, not
        its launch."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                device_sync(block_on)
            dt = time.perf_counter() - t0
            self.phases[name] = self.phases.get(name, 0.0) + dt
            if work_items is not None:
                self.work[name] = self.work.get(name, 0.0) + work_items

    def rates(self) -> dict[str, float]:
        return {
            name: self.work[name] / self.phases[name]
            for name in self.work
            if self.phases.get(name)
        }

    def report(self) -> str:
        lines = []
        for name, dt in sorted(self.phases.items(), key=lambda kv: -kv[1]):
            rate = self.rates().get(name)
            tail = f"  ({rate:,.3e} items/s)" if rate else ""
            lines.append(f"{name:>24s}: {dt:9.3f} s{tail}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a ``torch.profiler`` trace of the CPU and, where there is
    one, the card into ``log_dir`` (TensorBoard's trace format)."""
    from torch.profiler import (ProfilerActivity, profile,
                                tensorboard_trace_handler)

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class MetricsLog:
    """Append-only JSONL metrics file (one JSON object per event)."""

    def __init__(self, path: str):
        self.path = path

    def log(self, **fields) -> None:
        fields.setdefault("t", time.time())
        with open(self.path, "a") as f:
            f.write(json.dumps(fields) + "\n")

    def read(self) -> list[dict]:
        try:
            with open(self.path) as f:
                return [json.loads(ln) for ln in f if ln.strip()]
        except FileNotFoundError:
            return []
