"""The 95th percentile of the pairs' latencies in the window, in ms: each
pair timed from the hand-off of its call's host arrays to its answers on the
host (numpy's linear percentile)."""

import numpy as np


def read(window):
    return float(np.percentile(window["pair_latencies_ms"], 95))
