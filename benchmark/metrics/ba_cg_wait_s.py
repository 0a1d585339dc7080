"""Mean per pass of the program's span "ba.solve.cg.wait": the host
blocked on the device at each CG iteration's residual test in
``ba/solver.py:_pcg`` (summed over every CG iteration of the pass)."""

UNIT = "s"
LAYER = "ba/solver.py _pcg: host wait at each CG residual test"
MOVES = "frames_per_s"
KEY = "ba.solve.cg.wait"


def read(run):
    vals = [p["timers"][KEY] for p in run.passes if KEY in p["timers"]]
    return sum(vals) / len(vals) if vals else None
