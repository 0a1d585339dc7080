"""Mean per pass of the program's span "mvs.expand.wait": the host blocked
on each chunk's payload copy in the expansion loop (summed over the
chunks)."""

UNIT = "s"
LAYER = "mvs/pipeline.py expansion: host wait for each chunk's payload"
MOVES = "frames_per_s"
KEY = "mvs.expand.wait"


def read(run):
    vals = [p["timers"][KEY] for p in run.passes if KEY in p["timers"]]
    return sum(vals) / len(vals) if vals else None
