"""jac_dirs_per_s: Jacobian directions whose reduced tau, Lu and Ld
tangents (the primal with them) reached the host, over all the window's
time (host clock)."""


def read(run):
    return run.units / run.window_s if run.window_s > 0 else None
