"""Mean per pass of the program's span "mvs.expand.dispatch": the host's
enqueue of each chunk of expansion rounds (``mvs/expand.py``) and of its
payload's copy (summed over the chunks)."""

UNIT = "s"
LAYER = "mvs/pipeline.py expansion: host enqueue of rounds (mvs/expand.py)"
MOVES = "frames_per_s"
KEY = "mvs.expand.dispatch"


def read(run):
    vals = [p["timers"][KEY] for p in run.passes if KEY in p["timers"]]
    return sum(vals) / len(vals) if vals else None
