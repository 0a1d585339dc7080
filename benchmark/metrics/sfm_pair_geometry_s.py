"""Mean per pass of the program's SfM stage timer "pair_geometry"
(matching, RANSAC, triangulation over the pair chunks; ends in the copy
of its results to the host)."""

UNIT = "s"
LAYER = "sfm/pipeline.py pair_geometry: sfm/ransac.py"
MOVES = "frames_per_s"


def read(run):
    vals = [p["timers"]["pair_geometry"] for p in run.passes
            if "pair_geometry" in p["timers"]]
    return sum(vals) / len(vals) if vals else None
