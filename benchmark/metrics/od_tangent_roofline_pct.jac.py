"""K1 and K3's share of their roofline in the TUD Jacobian: the least time
of the member's Voigt OD (K1 ``full``) and of its tangents along the
request's directions (K3), the benchmark's counts from the inputs (the
reference's line parameters, the differentiable builder's window caps),
over the traced time of the ``fused_xsect_kernel`` and
``fused_xsect_jvp_kernel`` launches. Its work counts are its own."""

import numpy as np

from benchkit import lwir
from benchkit import work as yardstick
from benchkit.inputs.atmosphere import jacobian_directions, member

KERNELS = ("fused_xsect_kernel", "fused_xsect_jvp_kernel")


def work(cell, st, indices):
    """Least seconds of the traced requests' OD and OD tangents, as the
    sum of per-request bounds of each (operations or bytes)."""
    iso, lines, a, cap = lwir.reference_geometry(
        st.cfg, st.cols, None, ratio=lwir.DIFFERENTIABLE_RATIO)
    _, _, labels = jacobian_directions(a)
    x0, n = float(st.X[0]), st.X.size
    dx = float((st.X[-1] - st.X[0]) / (n - 1))
    mol = np.asarray(lines.mol_id)
    total, by = 0.0, set()
    for i in indices:
        prm = lwir.params(st.cfg, lines, iso,
                          member(a, st.draws, st.member_of(i)), None, cap)
        dirs = st.directions(i)
        live = np.zeros((len(dirs),) + prm.strength.shape, bool)
        for j, d in enumerate(dirs):
            key, layer = labels[d]
            live[j, layer] = True if key == "T" else mol == int(key)
        for ops, nbytes in (
                yardstick.voigt_od_work(prm, x0, dx, n,
                                        np.zeros(mol.size, bool)),
                yardstick.voigt_tangent_work(prm, x0, dx, n, live)):
            t, b = yardstick.bound(ops, nbytes)
            total += t
            by.add(b)
    return {"od_tangent_bound_s": total, "od_tangent_bound_by": sorted(by)}


def read(run):
    t = run.trace
    if t is None or "od_tangent_bound_s" not in run.work:
        return None
    dev = sum(t.device_s(match=k) for k in KERNELS)
    return 100.0 * run.work["od_tangent_bound_s"] / dev if dev > 0 else None
