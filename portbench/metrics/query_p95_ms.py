"""95th percentile, over all the window's queries, of the time from when a
query was due to be sent to when its answer resolved (a failed query counts
as infinitely late)."""
import numpy as np


def read(run):
    if run.latencies_ms is None or not len(run.latencies_ms):
        return None
    return float(np.percentile(run.latencies_ms, 95))
