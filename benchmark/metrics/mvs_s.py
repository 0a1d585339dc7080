"""Mean per pass of the benchmark's span around ``dense_reconstruction``
and the device sync after it."""

UNIT = "s"
LAYER = "mvs/pipeline.py dense_reconstruction: seed, expand, photoconsistency"
MOVES = "frames_per_s"


def read(run):
    vals = [p["mvs_s"] for p in run.passes if "mvs_s" in p]
    return sum(vals) / len(vals) if vals else None
