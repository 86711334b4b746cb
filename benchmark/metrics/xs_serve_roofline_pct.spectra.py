"""The table lookup's share of its roofline: 2 nL K nX FLOP and the table,
the weights and the OD once in bytes (bytes bound it) over the traced
device time of everything launched inside the ``od`` span around
``od_from_xs``."""

from benchkit.readers import roofline_pct


def read(run):
    return roofline_pct(run, "xs_bound_s", span="od")
