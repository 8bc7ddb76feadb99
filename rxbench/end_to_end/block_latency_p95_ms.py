"""The 95th percentile, over every block of the window, of the time from
the block's hand-over to the entry as a host array to its audio on the
host, after the control's update (numpy's linear interpolation)."""

import numpy as np


def read(window: dict):
    lat = window["latencies_s"]
    if not lat:
        return None
    return 1e3 * float(np.quantile(np.asarray(lat, np.float64), 0.95))
