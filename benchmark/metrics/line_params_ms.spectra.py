"""Device milliseconds a member launched inside the program's
``od.line_params`` span (the layer line parameters and the mixing
coefficients, plain torch), read from the run's program trace."""

from benchkit.program_spans import of, per, work  # noqa: F401


def read(run):
    pt = of(run)
    return None if pt is None else per(pt.device_ms("od.line_params"),
                                       pt.members)
