"""Readers that several per-layer metrics share (each metric's file under
``benchmark/metrics`` names one)."""


def idle_pct(run):
    """The share of the traced window with no kernel, copy or set on the
    card."""
    t = run.trace
    if t is None or t.window_s <= 0 or t.n_device == 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def roofline_pct(run, bound_key, kernel=None, span=None):
    """The benchmark's least time for the traced requests' work over the
    traced device time of the kernels named ``kernel`` (a substring of the
    name the profiler prints) or launched inside span ``span``."""
    t = run.trace
    if t is None or bound_key not in run.work:
        return None
    dev = t.device_s(match=kernel, span_name=span)
    if dev <= 0:
        return None
    return 100.0 * run.work[bound_key] / dev


def span_ms_per_member(run, span):
    """Device milliseconds a member of the activities launched inside
    span ``span``."""
    t = run.trace
    if t is None or run.members == 0 or t.n_attributed == 0:
        return None
    dev = t.device_s(span_name=span)
    return 1e3 * dev / run.members if dev > 0 else None
