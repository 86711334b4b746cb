"""Device milliseconds a direction of the kernels that are not the port's
hand-written ones (named by kernel; copies and sets left out): the plain
torch tangents of the continuum and of the TUD composition, the Planck
source, the reduction."""

#: the port's hand-written CUDA kernels (``radtxfr_tpu_torch/csrc``)
PORT_KERNELS = ("fused_xsect_kernel", "fused_xsect_jvp_kernel",
                "fused_sdvoigt_jvp_kernel", "fused_tud_kernel",
                "fused_ht_kernel", "unfused_xsect_kernel",
                "peak_probe_kernel", "rcp_approx_table_kernel")


def read(run):
    t = run.trace
    if t is None or run.units == 0:
        return None
    ns = sum(a.dur_ns for a in t.activities
             if not a.name.startswith(("Memcpy", "Memset"))
             and not any(k in a.name for k in PORT_KERNELS))
    return 1e-6 * ns / run.units if ns > 0 else None
