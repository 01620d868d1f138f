"""The 95th percentile over all the window's requests of a request's
time, host clock from the call to a synchronized x, in milliseconds."""

import numpy as np


def read(record):
    if not record.times:
        return None
    return float(np.percentile(record.times, 95)) * 1e3
