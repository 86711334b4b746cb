"""Spans and the device trace of a traced run.

The benchmark marks the calls it makes into the program's layers with
``torch.profiler.record_function`` ranges named ``bench.<layer>`` (the
spans; :func:`span`), and a traced run profiles its window with
``torch.profiler`` (CPU and CUDA activities), keeping the trace in memory.
:func:`analyse` reduces it to what the per-layer readers take:

* every device activity (kernel, copy, set) with its name, start, length
  and the span whose host interval holds its launch (the CUDA runtime
  call that shares its correlation id);
* ``busy_s``: the union of the device activities within the window, and
  ``window_s``: the window's length;
* ``breakdown``: the device operations that took most time, and the
  longest idle gaps named by the span the host was in when each began.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

import torch


@contextlib.contextmanager
def span(name: str):
    """A ``bench.<name>`` range around a call into the program."""
    with torch.profiler.record_function(f"bench.{name}"):
        yield


@dataclasses.dataclass
class Activity:
    name: str
    start_ns: int
    dur_ns: int
    span: str | None


class SpanIndex:
    """The innermost span holding a host time: spans of one thread nest,
    so among those that hold it, the one that began last."""

    def __init__(self, spans: dict):
        self.items = sorted((s, e, k) for k, v in spans.items()
                            for s, e in v)
        self.starts = [s for s, _, _ in self.items]

    def at(self, t, default=None):
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - 256, -1), -1):
            s, e, k = self.items[j]
            if e >= t:
                return k
        return default


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    activities: list
    spans: dict            # name -> [(start_ns, end_ns)]
    n_device: int
    n_attributed: int
    window: tuple = (0, 0)

    def device_s(self, match=None, span_name=None) -> float:
        """Seconds of device activity whose name contains ``match`` (None:
        any) launched inside span ``span_name`` (None: anywhere)."""
        return 1e-9 * sum(
            a.dur_ns for a in self.activities
            if (match is None or match in a.name)
            and (span_name is None or a.span == span_name))


def _union(intervals, lo, hi):
    total, end = 0, lo
    for s, e in sorted(intervals):
        s, e = max(s, end), min(e, hi)
        if e > s:
            total += e - s
            end = e
    return total


def profile_window(fn):
    """Run ``fn()`` under the profiler inside a ``bench.window`` span and
    return (fn's result, :class:`Trace`)."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with span("window"):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    return out, analyse(prof.profiler.kineto_results.events())


def analyse(events) -> Trace:
    """The :class:`Trace` of a list of kineto events."""
    spans, runtime, device = {}, {}, []
    for e in events:
        name = e.name()
        dev = str(e.device_type()).split(".")[-1]
        if dev == "CPU":
            if name.startswith("bench."):
                spans.setdefault(name[6:], []).append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
            elif name.startswith(("cuda", "cu")):
                runtime[e.correlation_id()] = e.start_ns()
        elif not e.is_user_annotation() and not name.startswith("bench."):
            device.append(e)
    win = spans.get("window", [(0, 0)])[0]
    inner = {k: sorted(v) for k, v in spans.items() if k != "window"}
    index = SpanIndex(inner)
    acts, n_attr = [], 0
    for e in device:
        host_t = runtime.get(e.correlation_id())
        sp = index.at(host_t) if host_t is not None else None
        n_attr += sp is not None
        acts.append(Activity(e.name(), e.start_ns(), e.duration_ns(), sp))
    busy = _union(((a.start_ns, a.start_ns + a.dur_ns) for a in acts),
                  win[0], win[1])
    return Trace(window_s=1e-9 * (win[1] - win[0]), busy_s=1e-9 * busy,
                 activities=acts, spans=inner, n_device=len(device),
                 n_attributed=n_attr, window=win)


def breakdown(trace: Trace, top: int = 10) -> dict:
    """The ``breakdown`` of the result line: the device operations with
    the most time (summed by name), and the longest idle gaps on the
    device within the window, each named by the innermost span that held
    the host when the gap began."""
    by = {}
    for a in trace.activities:
        by[a.name] = by.get(a.name, 0) + a.dur_ns
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = trace.window
    iv = sorted((a.start_ns, a.start_ns + a.dur_ns)
                for a in trace.activities)
    gaps, end = [], lo
    for s, e in iv + [(hi, hi)]:
        s = min(s, hi)
        if s > end:
            gaps.append((s - end, end))
        end = max(end, e)
    gaps.sort(reverse=True)
    index = SpanIndex(trace.spans)
    return {"device_ops": [[n[:200], 1e-9 * v] for n, v in ops],
            "idle_gaps": [[index.at(t, "outside spans"), 1e-9 * g]
                          for g, t in gaps[:top]]}
