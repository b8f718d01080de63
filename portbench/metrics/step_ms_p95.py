"""The 95th percentile of the intervals between consecutive step-end CUDA
events over the whole window (the first from an event at its start): a
step's time on the device's clock, any wait for input included."""

import numpy as np


def read(run):
    return float(np.percentile(run.intervals_ms, 95)) if run.intervals_ms else None
