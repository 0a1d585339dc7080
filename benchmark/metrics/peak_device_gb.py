"""``torch.cuda.max_memory_allocated()`` over the window, after
``reset_peak_memory_stats()`` at its start, in GB (1e9 bytes)."""

UNIT = "GB"
LAYER = "device memory: caching allocator"
MOVES = "frames_per_s"


def read(run):
    if run.peak_window_bytes is None:
        return None
    return run.peak_window_bytes / 1e9
