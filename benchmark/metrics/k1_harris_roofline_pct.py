"""K1's share of its roofline: the least time an H100 could take for one
Harris response over the stack (its bytes bound, from the cell's shapes)
over the mean device time of the traced passes' K1 kernels."""

from benchkit.roofline import harris_bound
from benchkit.trace import k1_times_us

UNIT = "%"
LAYER = "ops/harris.py K1 csrc/harris.cu"
MOVES = "frames_per_s"


def read(run):
    if run.profile is None:
        return None
    times = k1_times_us(run.profile)
    if not times:
        return None
    s = run.shapes
    bound_ms = harris_bound(s["frames"] * s["height"] * s["width"])["bound_ms"]
    return 100.0 * bound_ms / (sum(times) / len(times) / 1e3)
