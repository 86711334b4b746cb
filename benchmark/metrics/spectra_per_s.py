"""spectra_per_s: perturbed atmospheres whose reduced tau, Lu and Ld
reached the host, over all the window's time (host clock)."""


def read(run):
    return run.units / run.window_s if run.window_s > 0 else None
