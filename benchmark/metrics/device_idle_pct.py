"""The share of the profiled passes' wall in which no device operation
runs."""

UNIT = "%"
LAYER = "device: NVIDIA H100"
MOVES = "frames_per_s"


def read(run):
    p = run.profile
    if p is None or p["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - p["busy_s"] / p["window_s"])
