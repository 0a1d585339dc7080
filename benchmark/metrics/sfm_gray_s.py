"""Mean per pass of the program's span "features.gray": SfM's call of
``io/images.py:device_gray`` (cache lookup, host BT.601 conversion, rint to
uint8, pageable upload, conversion to float on the device)."""

UNIT = "s"
LAYER = "io/images.py device_gray: host gray conversion, uint8 upload"
MOVES = "frames_per_s"
KEY = "features.gray"


def read(run):
    vals = [p["timers"][KEY] for p in run.passes if KEY in p["timers"]]
    return sum(vals) / len(vals) if vals else None
