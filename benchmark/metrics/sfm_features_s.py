"""Mean per pass of the program's SfM stage timer "features" (host
grayscale conversion and upload, K1, K2; ends in a device sync)."""

UNIT = "s"
LAYER = "sfm/pipeline.py features: io/images.py device_gray, features/frontend.py K1 K2"
MOVES = "frames_per_s"


def read(run):
    vals = [p["timers"]["features"] for p in run.passes
            if "features" in p["timers"]]
    return sum(vals) / len(vals) if vals else None
