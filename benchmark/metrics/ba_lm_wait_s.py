"""Mean per pass of the program's span "ba.solve.wait": the host blocked
on the device at each LM iteration's stop test in ``ba/solver.py:solve_lm``
(summed over the iterations)."""

UNIT = "s"
LAYER = "ba/solver.py solve_lm: host wait at each LM stop test"
MOVES = "frames_per_s"
KEY = "ba.solve.wait"


def read(run):
    vals = [p["timers"][KEY] for p in run.passes if KEY in p["timers"]]
    return sum(vals) / len(vals) if vals else None
