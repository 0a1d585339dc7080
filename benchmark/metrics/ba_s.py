"""Mean per pass of the benchmark's span around ``bundle_adjust`` (which
ends in the copy of its solution to the host)."""

UNIT = "s"
LAYER = "ba/run.py bundle_adjust: ba/solver.py"
MOVES = "frames_per_s"


def read(run):
    vals = [p["ba_s"] for p in run.passes]
    return sum(vals) / len(vals) if vals else None
