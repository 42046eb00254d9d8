"""call_p95_s: the 95th percentile of the wall time of every
call in the window, each timed from its start."""
import numpy as np


def read(run):
    walls = [c["wall_s"] for c in run["calls"]]
    return float(np.percentile(walls, 95)) if walls else None
