"""The 95th percentile, in milliseconds, of every request answered in the
window, each timed from its call to the host copy of its answer."""
import numpy as np


def read(window):
    lat = window.get("latency_s")
    return float(np.percentile(np.asarray(lat) * 1e3, 95)) if lat else None
