"""request_ms_p95: the 95th percentile of every request of the window,
each timed from its dispatch to its products on the host (host clock)."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return 1e3 * float(np.percentile(np.asarray(run.latencies_s), 95.0))
