"""Device activities (kernels, copies, sets) a member launched inside the
program's ``od`` span, read from the run's program trace: a count, the
same in every run of a cell while the plans are."""

from benchkit.program_spans import of, per, work  # noqa: F401


def read(run):
    pt = of(run)
    return None if pt is None else per(pt.launches("od"), pt.members)
