"""K2's share of its roofline: the least time of the TUD composition (the
special-function ops of its exponentials bound it) over the traced time of
the ``fused_tud_kernel`` launches."""

from benchkit.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k2_bound_s", kernel="fused_tud_kernel")
