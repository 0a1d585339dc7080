"""K2's share of its roofline in SfM's descriptor call: the bytes bound of
N x max_corners samples of (2 desc_wid + 1)^2 from the bf16 stack, from the
cell's shapes, over the mean device time of the traced passes' SfM K2
kernels."""

from benchkit.roofline import gather_bound
from benchkit.trace import k2_sfm_times_us

UNIT = "%"
LAYER = "ops/gather.py K2 csrc/gather.cu"
MOVES = "frames_per_s"


def read(run):
    if run.profile is None:
        return None
    times = k2_sfm_times_us(run.profile)
    if not times:
        return None
    s = run.shapes
    bound_ms = gather_bound(s["frames"] * s["height"] * s["width"],
                            s["frames"] * s["max_corners"],
                            s["desc_wid"])["bound_ms"]
    return 100.0 * bound_ms / (sum(times) / len(times) / 1e3)
