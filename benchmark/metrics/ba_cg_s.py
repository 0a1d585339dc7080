"""Mean per pass of the program's span "ba.solve.cg": the joint LM loop's
reduced camera solves by preconditioned conjugate gradients in
``ba/solver.py:solve_lm`` (summed over the LM iterations), host waits
included."""

UNIT = "s"
LAYER = "ba/solver.py _pcg: the joint solve's reduced camera system by PCG"
MOVES = "frames_per_s"
KEY = "ba.solve.cg"


def read(run):
    vals = [p["timers"][KEY] for p in run.passes if KEY in p["timers"]]
    return sum(vals) / len(vals) if vals else None
