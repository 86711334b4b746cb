"""Device milliseconds a member of everything launched inside the
``reduce`` span around the banded reduction."""

from benchkit.readers import span_ms_per_member


def read(run):
    return span_ms_per_member(run, "reduce")
