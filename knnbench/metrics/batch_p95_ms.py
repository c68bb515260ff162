"""batch_p95_ms (ms): the 95th percentile, over every batch of the window,
of the time from the batch's dispatch to its answers on the host (host
clock; numpy's linear interpolation)."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile(run.latencies, 95)) if run.latencies else None
