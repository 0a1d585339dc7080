"""Frames of every reconstruction completed in the window over the time
from the window's start to the end of the last one: a batch user's
throughput."""

UNIT = "frames/s"


def read(run):
    if not run.passes:
        return None
    return run.frames * len(run.passes) / run.window_wall_s
