"""Device kernels of the profiled passes (copies and fills left out) over
the passes."""

UNIT = "kernels"
LAYER = "device: NVIDIA H100"
MOVES = "frames_per_s"


def read(run):
    p = run.profile
    if p is None or not p["kernels"]:
        return None
    return len(p["kernels"]) / p["passes"]
