"""itl_p95_ms (ms): the 95th percentile of every gap between two consecutive
tokens of one request inside the window (host clock at each step's
return)."""
import numpy as np


def read(run):
    if run.gaps_s.size == 0:
        return None
    return 1e3 * float(np.percentile(run.gaps_s, 95))
