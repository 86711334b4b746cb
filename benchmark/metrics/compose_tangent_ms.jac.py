"""Device milliseconds a direction launched inside the program's ``tud``
span within ``jacobian.tangent`` (the plain-torch composition and its
tangents), read from the run's program trace."""

from benchkit.program_spans import of, per, work  # noqa: F401


def read(run):
    pt = of(run)
    return None if pt is None else per(
        pt.device_ms("tud", within="jacobian.tangent"), pt.units)
