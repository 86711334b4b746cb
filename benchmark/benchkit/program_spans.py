"""The program's own spans in a traced run, beside the benchmark's.

The port opens ``radtxfr.<name>`` ranges around its layers while a
profiler records (``radtxfr_tpu_torch.utils.span``: ``od``,
``od.line_params``, ``od.continuum``, ``k1.<mode>``, ``tud``, ``reduce``,
``jacobian.tangent``, ...): function-scope host ops, so the profiler
links each launch made in one (outside any ATen op) to it, and each made
in an ATen op to that op, whose start lies on the same host clock.
:func:`analyse` reads one kineto event list into a
:class:`ProgramTrace`:

* ``trace``: :func:`.tracing.analyse` of the same events, unchanged (it
  reads the benchmark's spans and leaves the program's alone);
* ``paths``: for each of its device activities, the program spans that
  held the host when it was launched, outermost first, found by nesting
  over every span of the trace (no look-back limit: a Jacobian's
  ``jacobian.tangent`` holds thousands);
* ``gaps``: each idle gap of the device within the window, with the
  benchmark span and the program path the host was in when it began.

:func:`analyse` leaves :func:`.tracing.analyse`'s ``Trace`` and the
result line's ``breakdown`` as they are, so the harness's own traced
window keeps its readings. The metrics that read program spans take them
from a second profiled pass of the window's requests (:func:`capture`,
each metric file's ``work``), once a run: the same requests, inputs and
shapes, after the window.
"""

from __future__ import annotations

import bisect
import dataclasses
import sys
import time

import torch

from . import tracing

PREFIX = "radtxfr."
#: seconds of profiler session before and after the profiled requests
MARGIN_S = 0.05


@dataclasses.dataclass
class Gap:
    start_ns: int
    dur_ns: int
    bench: str               # innermost benchmark span, or "outside spans"
    path: tuple              # program spans holding the host, outermost first

    @property
    def name(self) -> str:
        """``<bench span>/<innermost program span>``, or the bench span."""
        return f"{self.bench}/{self.path[-1]}" if self.path else self.bench


@dataclasses.dataclass
class ProgramTrace:
    trace: tracing.Trace
    paths: list              # per trace.activities: tuple of span names
    spans: dict              # program span name -> [(start_ns, end_ns)]
    gaps: list               # [Gap], longest first
    requests: int = 0
    members: int = 0
    units: int = 0
    linked: int = 0          # activities placed by their host op
    shift: tuple = (0, 0)    # clock_shift at the window's ends, ns

    def _in(self, name, within=None):
        for a, path in zip(self.trace.activities, self.paths):
            if name in path and (within is None or within in path):
                yield a

    def device_ms(self, name: str, within: str | None = None):
        """Device milliseconds of the activities launched in span ``name``
        (anywhere on the path), and inside ``within`` too where given;
        None when the trace holds no such span."""
        if name not in self.spans or (within and within not in self.spans):
            return None
        return 1e-6 * sum(a.dur_ns for a in self._in(name, within))

    def launches(self, name: str):
        """Device activities (kernels, copies, sets) launched in span
        ``name``; None when the trace holds no such span."""
        if name not in self.spans:
            return None
        return sum(1 for _ in self._in(name))

    def idle_ms(self, name: str):
        """Milliseconds of the window's device-idle gaps that began while
        the host was in span ``name``; None when the trace holds none."""
        if name not in self.spans:
            return None
        return 1e-6 * sum(g.dur_ns for g in self.gaps if name in g.path)

    def by_path(self) -> dict:
        """(device ns, launches) of each program path."""
        out = {}
        for a, path in zip(self.trace.activities, self.paths):
            ns, n = out.get(path, (0, 0))
            out[path] = (ns + a.dur_ns, n + 1)
        return out


def paths_at(spans: dict, times: list) -> list:
    """For each host time, the spans of ``spans`` (name -> [(start, end)])
    that hold it, outermost first: a sweep over the spans in order of start
    (an outer span, starting no later and ending no earlier, comes
    first)."""
    items = sorted((s, -e, k) for k, v in spans.items() for s, e in v)
    order = sorted(range(len(times)), key=lambda i: times[i])
    out, open_, j = [None] * len(times), [], 0
    for i in order:
        t = times[i]
        while j < len(items) and items[j][0] <= t:
            open_.append(items[j])
            j += 1
        open_ = [it for it in open_ if -it[1] >= t]
        out[i] = tuple(k for _, _, k in open_)
    return out


def _gaps(trace: tracing.Trace, shift=lambda t: 0) -> list:
    """The window's idle gaps as (start_ns, length_ns) on the device's
    clock, as :func:`.tracing.breakdown` finds them; ``shift`` brings the
    window's ends (host ranges) onto it."""
    lo, hi = (t - shift(t) for t in trace.window)
    iv = sorted((a.start_ns, a.start_ns + a.dur_ns)
                for a in trace.activities)
    gaps, end = [], lo
    for s, e in iv + [(hi, hi)]:
        s = min(s, hi)
        if s > end:
            gaps.append((end, s - end))
        end = max(end, e)
    return gaps


def clock_shift(pairs, k: int = 8):
    """``shift(t)``: what brings a time of the CUDA runtime's clock (that
    of the runtime calls and of the device's activities) onto the clock of
    the host ranges, which the profiler stamps apart and which drift apart
    by up to milliseconds over seconds. Each pair is a runtime call
    (start, end) and the host op it was launched in (start, end), so the
    shift at that call lies in [op start - call start, op end - call end].
    At ``t`` it is the middle of what the ``k`` calls on either side of
    ``t`` all allow, or of the narrowest of them where drift leaves no
    common point."""
    pairs = sorted(pairs)
    starts = [r0 for (r0, _), _ in pairs]

    def shift(t):
        i = bisect.bisect_right(starts, t)
        near = [(o0 - r0, o1 - r1)
                for (r0, r1), (o0, o1) in pairs[max(0, i - k):i + k]]
        if not near:
            return 0
        lo, hi = max(a for a, _ in near), min(b for _, b in near)
        if lo > hi:
            lo, hi = min(near, key=lambda ab: ab[1] - ab[0])
        return (lo + hi) // 2

    return shift


def analyse(events, requests: int = 0, members: int = 0,
            units: int = 0) -> ProgramTrace:
    """The :class:`ProgramTrace` of a list of kineto events (``requests``,
    ``members`` and ``units``: of the profiled requests, for the readers'
    shares).

    A device activity is placed by the host op it was launched in (its
    linked correlation id: an ATen op, or the innermost program span where
    no op was open), whose start is on the clock of the program's spans;
    one that links to none, and each gap's start, by the runtime's clock
    brought onto the host's by :func:`clock_shift`."""
    events = list(events)
    base = tracing.analyse(events)
    spans, runtime, ops, device = {}, {}, {}, []
    for e in events:
        name = e.name()
        if str(e.device_type()).split(".")[-1] == "CPU":
            t = (e.start_ns(), e.start_ns() + e.duration_ns())
            if name.startswith(("cuda", "cu")):
                runtime[e.correlation_id()] = t
                continue
            if e.correlation_id() > 0:
                ops[e.correlation_id()] = t
            if name.startswith(PREFIX):
                spans.setdefault(name[len(PREFIX):], []).append(t)
        elif not e.is_user_annotation() and not name.startswith("bench."):
            # the device activities of tracing.analyse, in its order
            device.append((e.linked_correlation_id(), e.correlation_id()))
    device = [(ops.get(link), runtime.get(corr)) for link, corr in device]
    shift = clock_shift([(r, o) for o, r in device if o and r])
    launch = [o[0] if o else (r[0] + shift(r[0]) if r else None)
              for o, r in device]
    known = [i for i, t in enumerate(launch) if t is not None]
    found = paths_at(spans, [launch[i] for i in known])
    paths = [()] * len(launch)
    for i, p in zip(known, found):
        paths[i] = p
    gaps = sorted(_gaps(base, shift), key=lambda g: -g[1])
    host = [s + shift(s) for s, _ in gaps]
    index = tracing.SpanIndex(base.spans)
    return ProgramTrace(
        trace=base, paths=paths, spans=spans,
        gaps=[Gap(s, d, index.at(t, "outside spans"), p) for (s, d), t, p
              in zip(gaps, host, paths_at(spans, host))],
        requests=requests, members=members, units=units,
        linked=sum(1 for o, _ in device if o),
        shift=tuple(shift(t) for t in base.window))


def profile_requests(driver, state, indices) -> ProgramTrace:
    """Requests ``indices`` again, back to back, under the profiler (CPU
    and CUDA) inside a ``bench.window`` span."""
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        # the profiler keeps no device record stamped outside its session,
        # and the device's clock stands up to milliseconds from the host's
        time.sleep(MARGIN_S)
        with tracing.span("window"):
            recs = [driver.request(state, i) for i in indices]
            if cuda:
                torch.cuda.synchronize()
        time.sleep(MARGIN_S)
    per = getattr(state, "members_per_request", 1)
    return analyse(prof.profiler.kineto_results.events(),
                   requests=len(recs), members=per * len(recs),
                   units=sum(r.units for r in recs))


def capture(cell, state, indices) -> ProgramTrace:
    """The run's :class:`ProgramTrace`, profiled once a run (kept on the
    driver's state) and reported on standard error."""
    pt = getattr(state, "program_trace", None)
    if pt is None:
        driver = (sys.modules.get(f"bench_driver_{cell.traffic['driver']}")
                  or cell.driver())
        pt = profile_requests(driver, state, list(indices))
        state.program_trace = pt
        report(pt)
    return pt


def work(cell, state, indices) -> dict:
    """A metric file's ``work``: the run's program trace, under a key the
    rooflines and the result line's ``bound_by`` do not read."""
    return {"program_trace": capture(cell, state, indices)}


def of(run) -> ProgramTrace | None:
    return run.work.get("program_trace") if run.trace is not None else None


def per(value, n):
    return None if value is None or n <= 0 else value / n


def report(pt: ProgramTrace, top: int = 20, file=None) -> None:
    """Standard error's ``program spans:`` line (device ms and launches a
    request of each program path, the most time first), its ``program
    gaps:`` line (the longest idle gaps, named ``<bench span>/<innermost
    program span>``) and its ``program ops:`` line (the device operations
    with the most time, each with the path that holds most of it)."""
    file = sys.stderr if file is None else file
    n = max(1, pt.requests)
    rows = sorted(pt.by_path().items(), key=lambda kv: -kv[1][0])[:top]
    print("program spans: " + "; ".join(
        f"{'/'.join(p) or '(none)'} {1e-6 * ns / n:.4f} ms {c / n:.2f} "
        f"launches" for p, (ns, c) in rows) + f" (a request; {n} requests; "
        f"{pt.linked} of {len(pt.paths)} activities placed by their host op; "
        f"runtime clock shift {pt.shift[0]} to {pt.shift[1]} ns)",
        file=file)
    print("program gaps: " + "; ".join(
        f"{g.name} {1e-6 * g.dur_ns:.4f} ms" for g in pt.gaps[:10]),
        file=file)
    ops = {}
    for a, p in zip(pt.trace.activities, pt.paths):
        d = ops.setdefault(a.name, {})
        d[p] = d.get(p, 0) + a.dur_ns
    lead = sorted(ops.items(), key=lambda kv: -sum(kv[1].values()))[:10]
    print("program ops: " + "; ".join(
        f"{name[:80]} {1e-6 * sum(d.values()) / n:.4f} ms in "
        f"{'/'.join(max(d, key=d.get)) or '(none)'}" for name, d in lead),
        file=file)
