"""Milliseconds a member that the card sat idle in gaps of the window
which began while the host was inside the program's ``od`` span, read
from the run's program trace."""

from benchkit.program_spans import of, per, work  # noqa: F401


def read(run):
    pt = of(run)
    return None if pt is None else per(pt.idle_ms("od"), pt.members)
