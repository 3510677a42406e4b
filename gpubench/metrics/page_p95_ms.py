"""The 95th percentile (numpy's linear interpolation) of the time of every
call of the window, each from its call to its return, in ms (host
clock)."""
import numpy as np


def read(rec):
    return float(np.percentile([(c["t1"] - c["t0"]) * 1e3
                                for c in rec["calls"]], 95))
