"""The trace analysis on synthetic kineto events: the program's
``radtxfr.*`` ranges leave the benchmark's own analysis and every existing
reader as they were; ``program_spans`` ties each launch to the program
spans that held it (past any look-back), names idle gaps by both kinds of
span, and the six readers of program spans return the values worked out
by hand; the registry finds their files."""

from __future__ import annotations

import io
import os
import sys

import pytest
import torch

from bench_tiny import ROOT
from benchkit import program_spans, registry, tracing
from benchkit.harness import Run

SPEC = registry.benchmark_spec(ROOT)
NEW = ("line_params_ms.spectra", "continuum_ms.spectra",
       "od_launches.spectra", "od_idle_ms.spectra", "od_tangent_ms.jac",
       "compose_tangent_ms.jac")


class Ev:
    """A kineto event as ``tracing.analyse`` reads one."""

    def __init__(self, name, dev, start, dur, corr=0, annotation=False,
                 link=0):
        self._name, self._dev = name, dev
        self._start, self._dur, self._corr = start, dur, corr
        self._annotation, self._link = annotation, link

    def name(self):
        return self._name

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def start_ns(self):
        return self._start

    def duration_ns(self):
        return self._dur

    def correlation_id(self):
        return self._corr

    def is_user_annotation(self):
        return self._annotation

    def linked_correlation_id(self):
        return self._link


def cpu(name, start, end):
    return Ev(name, "CPU", start, end - start)


def launch(corr, at, kernel, start, dur, shift=0):
    """An ATen op around host time ``at``, the runtime call in it and the
    device activity it launched (linked to the op); ``shift`` moves the
    runtime's and the device's clock against the host ranges'."""
    op = 1000 + corr
    return [Ev("aten::op", "CPU", at - 2, 9, op),
            Ev("cudaLaunchKernel", "CPU", at + shift, 5, corr),
            Ev(kernel, "CUDA", start + shift, dur, corr, link=op)]


def program(name, start, end):
    """A program span: its CPU range and, as kineto records one, its range
    on the device's timeline (a user annotation)."""
    return [cpu("radtxfr." + name, start, end),
            Ev("radtxfr." + name, "CUDA", start + 5, end - start,
               annotation=True)]


#: one member: the benchmark's spans, and the launches, by host time
BENCH = [cpu("bench.window", 0, 1000), cpu("bench.member", 10, 900),
         cpu("bench.od", 20, 700), cpu("bench.tud", 700, 800),
         cpu("bench.reduce", 800, 890)]


def launches(shift=0):
    return (launch(1, 50, "mul_line_params", 60, 20, shift)
            + launch(2, 120, "fused_xsect_kernel", 130, 100, shift)
            + launch(3, 220, "indexFuncLargeIndex", 240, 10, shift)
            + launch(4, 320, "mul_continuum", 330, 50, shift)
            + launch(5, 400, "Memset (Device)", 420, 5, shift)
            + launch(6, 683, "add", 690, 30, shift)
            + launch(7, 720, "fused_tud_kernel", 730, 40, shift)
            + launch(8, 820, "sum_reduce", 830, 20, shift))


LAUNCHES = launches()
#: the program's spans around the same launches
PROGRAM = (program("od", 30, 690) + program("od.line_params", 40, 100)
           + program("k1.asym", 110, 200) + program("k1.merge", 210, 230)
           + program("od.continuum", 300, 680) + program("tud", 710, 790)
           + program("reduce", 810, 880))
#: the idle gaps of the window, (start, length): hand-listed
GAPS = [(0, 60), (80, 50), (230, 10), (250, 80), (380, 40), (425, 265),
        (720, 10), (770, 60), (850, 150)]


def _run(trace, work=None, members=2, units=2):
    return Run(setup_s=1.0, plan_build_s=0.5, window_s=1e-6,
               latencies_s=[1e-6], units=units, attempted=1, failed=0,
               members=members, trace=trace, work=dict(work or {}),
               memory_peak_bytes=0, cell=None)


#: work counts of every roofline, so each existing reader reads a number
BOUNDS = {"k1_bound_s": 1e-7, "k2_bound_s": 2e-8, "xs_bound_s": 3e-7,
          "od_tangent_bound_s": 4e-8}


def test_program_ranges_leave_the_benchmark_analysis_as_it_was():
    """With and without the program's ranges (CPU and device annotation):
    the same activities, spans, busy and window, device operations
    (``device_ops``) and idle gaps, and every per-layer reader that was
    there the same value."""
    without = tracing.analyse(BENCH + LAUNCHES)
    with_ = tracing.analyse(BENCH + PROGRAM + LAUNCHES)
    assert with_ == without
    assert (with_.n_device, with_.n_attributed) == (8, 8)
    assert tracing.breakdown(with_) == tracing.breakdown(without)
    old = [m["name"] for m in SPEC["per_layer"] if m["name"] not in NEW]
    assert len(old) == 12
    for name in old:
        cell = registry.Cell(SPEC, m_cell(name), ROOT)
        read = cell.reader(name)
        a, b = read(_run(without, BOUNDS)), read(_run(with_, BOUNDS))
        assert a == b and a is not None, name


def m_cell(metric):
    return next(m for m in SPEC["per_layer"]
                if m["name"] == metric)["workloads"][0]


def test_program_path_of_each_launch_and_gap_names():
    pt = program_spans.analyse(BENCH + PROGRAM + LAUNCHES, requests=1,
                               members=2, units=2)
    assert pt.paths == [("od", "od.line_params"), ("od", "k1.asym"),
                        ("od", "k1.merge"), ("od", "od.continuum"),
                        ("od", "od.continuum"), ("od",), ("tud",),
                        ("reduce",)]
    assert [a.span for a in pt.trace.activities] == \
        ["od"] * 6 + ["tud", "reduce"]
    assert sorted((g.start_ns, g.dur_ns) for g in pt.gaps) == GAPS
    names = {g.start_ns: g.name for g in pt.gaps}
    assert names == {0: "outside spans", 80: "od/od.line_params",
                     230: "od/k1.merge", 250: "od/od", 380: "od/od.continuum",
                     425: "od/od.continuum", 720: "tud/tud", 770: "tud/tud",
                     850: "reduce/reduce"}
    # without program spans the names are the benchmark's alone
    bare = program_spans.analyse(BENCH + LAUNCHES)
    assert {g.name for g in bare.gaps} == {"outside spans", "od", "tud",
                                           "reduce"}
    assert bare.paths == [()] * 8


def test_launches_and_gaps_placed_across_a_clock_offset():
    """The runtime's and the device's clock 37 ns behind the host ranges'
    (the profiler stamps them apart): launches are placed by their host
    op, gaps by the shift the runtime calls bound (37 ns here: the middle
    of [35, 39]); the readings are those of the aligned clocks."""
    aligned = program_spans.analyse(BENCH + PROGRAM + LAUNCHES, 1, 2, 2)
    off = program_spans.analyse(BENCH + PROGRAM + launches(-37), 1, 2, 2)
    assert off.shift == (37, 37) and aligned.shift == (0, 0)
    assert off.paths == aligned.paths and off.linked == 8

    def inner(pt):     # the gaps between activities, in order
        return [(g.dur_ns, g.name) for g in sorted(
            pt.gaps, key=lambda g: g.start_ns)][1:-1]

    assert inner(off) == inner(aligned) and len(inner(off)) == 7
    for name in ("od.line_params", "od.continuum"):
        assert off.device_ms(name) == aligned.device_ms(name)
    assert off.launches("od") == 6 and off.idle_ms("od") == \
        aligned.idle_ms("od")


def test_clock_shift_from_neighbouring_calls():
    """A wide pair (a launch linked to a long span) narrows nothing; calls
    that disagree (drift) fall back to the narrowest; with ``k`` = 1 each
    time takes the calls next to it."""
    shift = program_spans.clock_shift([((100, 105), (98, 107)),
                                       ((200, 205), (150, 400)),
                                       ((300, 305), (298, 307))])
    assert shift(210) == 0 and shift(0) == 0
    drift = [((100, 105), (148, 157)), ((1000, 1005), (1098, 1107))]
    assert program_spans.clock_shift(drift)(500) == 50
    local = program_spans.clock_shift(drift, k=1)
    assert (local(100), local(1000)) == (50, 100)
    assert program_spans.clock_shift([])(5) == 0


def test_program_path_past_256_spans():
    """A launch 300 spans after its outermost span began is still tied
    to it (the benchmark's look-back stops at 256)."""
    events = [cpu("bench.window", 0, 10**6), cpu("bench.jacobian", 1, 10**6)]
    events += program("jacobian.tangent", 10, 900_000)
    for i in range(300):
        events += program("k1.full", 100 + 100 * i, 150 + 100 * i)
        events += launch(10 + i, 120 + 100 * i, "k3", 120 + 100 * i, 10)
    events += launch(5, 40_000, "mul", 40_010, 1000)
    pt = program_spans.analyse(events)
    assert pt.paths[-1] == ("jacobian.tangent",)
    assert pt.paths[0] == ("jacobian.tangent", "k1.full")
    assert len(pt.spans["k1.full"]) == 300
    assert pt.device_ms("jacobian.tangent") == pytest.approx(
        1e-6 * (300 * 10 + 1000))


def _jacobian_events():
    ev = [cpu("bench.window", 0, 500), cpu("bench.jacobian", 5, 450)]
    ev += (program("jacobian.primal", 10, 100) + program("od", 20, 50)
           + program("tud", 60, 90) + program("jacobian.tangent", 110, 400)
           + program("od", 120, 200) + program("tud", 210, 390))
    ev += (launch(11, 30, "fused_xsect_kernel", 40, 10)
           + launch(12, 70, "fused_tud_kernel", 60, 15)
           + launch(13, 130, "fused_xsect_jvp_kernel", 140, 25)
           + launch(14, 220, "elementwise_kernel MulFunctor", 230, 100)
           + launch(15, 393, "copy", 400, 7))
    return ev


@pytest.mark.parametrize("name,events,want", [
    # members 2: device ns in the span over 2, in ms
    ("line_params_ms.spectra", "member", 1e-6 * 20 / 2),
    ("continuum_ms.spectra", "member", 1e-6 * (50 + 5) / 2),
    ("od_launches.spectra", "member", 6 / 2),
    ("od_idle_ms.spectra", "member", 1e-6 * (50 + 10 + 80 + 40 + 265) / 2),
    # units (directions) 4: the tangent's od and tud, not the primal's
    ("od_tangent_ms.jac", "jacobian", 1e-6 * 25 / 4),
    ("compose_tangent_ms.jac", "jacobian", 1e-6 * 100 / 4),
])
def test_each_new_reader_reads_the_hand_value(name, events, want):
    ev = (BENCH + PROGRAM + LAUNCHES if events == "member"
          else _jacobian_events())
    members, units = (2, 2) if events == "member" else (1, 4)
    pt = program_spans.analyse(ev, requests=1, members=members, units=units)
    read = registry.Cell(SPEC, m_cell(name), ROOT).reader(name)
    assert read(_run(pt.trace, {"program_trace": pt}, members,
                     units)) == pytest.approx(want)
    # no program trace, or a program without the span: no value
    assert read(_run(pt.trace)) is None
    bare = program_spans.analyse(BENCH + LAUNCHES, 1, members, units)
    assert read(_run(bare.trace, {"program_trace": bare})) is None


def test_registry_finds_the_new_metric_files():
    per_layer = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NEW:
        entry = per_layer[name]
        assert entry["source"] == "device_trace"
        assert entry["better"] == "lower"
        for w in entry["workloads"]:
            cell = registry.Cell(SPEC, w, ROOT)
            assert name in [m["name"] for m in cell.per_layer]
            assert os.path.isfile(cell.metric_path(name))
            mod = cell.metric_module(name)
            assert callable(mod.read) and callable(mod.work)


class _Driver:
    def __init__(self):
        self.calls = 0

    def request(self, state, i):
        from radtxfr_tpu_torch.utils import span

        self.calls += 1
        with tracing.span("od"), span("od"):
            torch.ones(8).sum()
        return type("Rec", (), {"units": 3})()


class _State:
    members_per_request = 2


class _Cell:
    traffic = {"driver": "spans_test"}


def test_capture_profiles_once_a_run_and_reports(monkeypatch, capsys):
    """The metric files' ``work``: one second profiled pass a run (kept on
    the state), its report on standard error."""
    driver, state = _Driver(), _State()
    monkeypatch.setitem(sys.modules, "bench_driver_spans_test", driver)
    first = program_spans.work(_Cell(), state, [0, 1])["program_trace"]
    again = program_spans.work(_Cell(), state, [0, 1])["program_trace"]
    assert again is first and driver.calls == 2
    assert (first.requests, first.members, first.units) == (2, 4, 6)
    assert len(first.spans["od"]) == 2
    err = capsys.readouterr().err
    for line in ("program spans: ", "program gaps: ", "program ops: "):
        assert line in err


def test_report_lines():
    pt = program_spans.analyse(BENCH + PROGRAM + LAUNCHES, requests=1,
                               members=2, units=2)
    out = io.StringIO()
    program_spans.report(pt, file=out)
    lines = out.getvalue().splitlines()
    assert lines[0].startswith("program spans: od/k1.asym 0.0001 ms 1.00 "
                               "launches")
    assert lines[1].startswith("program gaps: od/od.continuum 0.0003 ms")
    assert "fused_xsect_kernel 0.0001 ms in od/k1.asym" in lines[2]
