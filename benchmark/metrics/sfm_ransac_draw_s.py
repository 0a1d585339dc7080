"""Mean per pass of the program's span "pair_geometry.draw":
``sfm/ransac.py:draw_uniforms``, the RANSAC uniforms drawn on the host's
CPU generator."""

UNIT = "s"
LAYER = "sfm/ransac.py draw_uniforms: RANSAC uniforms on the host"
MOVES = "frames_per_s"
KEY = "pair_geometry.draw"


def read(run):
    vals = [p["timers"][KEY] for p in run.passes if KEY in p["timers"]]
    return sum(vals) / len(vals) if vals else None
