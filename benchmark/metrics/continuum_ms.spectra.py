"""Device milliseconds a member launched inside the program's
``od.continuum`` span (the MT_CKD term and its addition to the line OD),
read from the run's program trace."""

from benchkit.program_spans import of, per, work  # noqa: F401


def read(run):
    pt = of(run)
    return None if pt is None else per(pt.device_ms("od.continuum"),
                                       pt.members)
