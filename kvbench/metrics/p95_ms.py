"""p95_ms (ms): the 95th percentile (``numpy.percentile``, linear) of the
latencies of all requests of the window, each from its issue to its
results on the host."""

import numpy as np


def read(run):
    if not run.latencies_s:
        return None
    return float(np.percentile(run.latencies_s, 95)) * 1e3
