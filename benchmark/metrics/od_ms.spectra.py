"""Device milliseconds a member of everything launched inside the ``od``
span around ``od_fn`` (line parameters, K1, continuum, merge)."""

from benchkit.readers import span_ms_per_member


def read(run):
    return span_ms_per_member(run, "od")
