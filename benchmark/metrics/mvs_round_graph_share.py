"""Share of the MVS expansion rounds that could run by CUDA graph replay
and did: the program's counters ``dense_reconstruction.rounds_replayed``
over ``rounds_dispatched - rounds_first`` (the rounds of each call's first
chunk run eagerly, whatever the device), read at the end of the run.  None
where the program has no such counters or dispatched no round after a
call's first chunk."""

UNIT = "share"
LAYER = "mvs/pipeline.py expansion: host enqueue of rounds (mvs/expand.py)"
MOVES = "frames_per_s"
COUNTERS = ("rounds_dispatched", "rounds_first", "rounds_replayed")


def read(run):
    from sfm_tpu_torch.mvs.pipeline import dense_reconstruction

    counts = [getattr(dense_reconstruction, k, None) for k in COUNTERS]
    if None in counts:
        return None
    dispatched, first, replayed = counts
    if dispatched <= first:
        return None
    return replayed / (dispatched - first)
