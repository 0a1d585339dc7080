"""The 90th percentile of the wall of each reconstruction in the window,
over all of them: the wait for one dataset, tail included."""

import numpy as np

UNIT = "s"


def read(run):
    if not run.passes:
        return None
    return float(np.percentile([p["wall"] for p in run.passes], 90))
