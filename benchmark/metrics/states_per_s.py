"""states_per_s: (T, p) cross-section rows on the host, over all the
window's time (host clock)."""


def read(run):
    return run.units / run.window_s if run.window_s > 0 else None
