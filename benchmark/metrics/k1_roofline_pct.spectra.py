"""K1's share of its roofline in the production member: the least time of
the Voigt OD's evaluations (the benchmark's count from the inputs, bound by
operations) over the traced time of the ``fused_xsect_kernel`` launches."""

from benchkit.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k1_bound_s", kernel="fused_xsect_kernel")
