"""Device milliseconds a direction launched inside the program's ``od``
span within ``jacobian.tangent`` (K1 ``full``, K3, the line parameters'
and the continuum's tangents), read from the run's program trace."""

from benchkit.program_spans import of, per, work  # noqa: F401


def read(run):
    pt = of(run)
    return None if pt is None else per(
        pt.device_ms("od", within="jacobian.tangent"), pt.units)
