"""The wall of the process's first reconstruction, after the libraries
are loaded and the context exists: what a CLI user (one process a
dataset) waits for beyond decode.  Part of set-up; one sample a run."""

UNIT = "s"
LAYER = "program cold path: first calls of every op, allocator growth, library handles"
MOVES = "setup_s"


def read(run):
    return run.first_recon_s
