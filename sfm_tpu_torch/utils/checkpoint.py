"""Stage checkpointing / resume.

Counterpart of ``sfm_tpu/utils/checkpoint.py``, with the same file names and
array names, so either package reads the other's files.  Each stage
boundary (tracks after SfM, refined points after BA) serialises to one
``.npz`` so a stage can restart from the previous one, and the MVS stage
also checkpoints mid-expansion (occupancy + frontier + backlog +
accumulated cloud every K rounds, see ``mvs.pipeline``), so a crash in the
longest stage resumes from the last round boundary.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

from sfm_tpu_torch.io.calib import Calibration
from sfm_tpu_torch.sfm.pipeline import SparseReconstruction


def save_sparse(path: str, recon: SparseReconstruction) -> None:
    np.savez_compressed(
        path,
        world=recon.world,
        track_offsets=recon.track_offsets,
        track_obs=recon.track_obs,
        K=recon.calib.K,
        R=recon.calib.R,
        t=recon.calib.t,
        names=np.asarray(recon.calib.names),
    )


def load_sparse(path: str) -> SparseReconstruction:
    z = np.load(path, allow_pickle=False)
    calib = Calibration(
        K=z["K"], R=z["R"], t=z["t"], names=tuple(z["names"].tolist())
    )
    return SparseReconstruction(
        calib=calib,
        world=z["world"],
        track_offsets=z["track_offsets"],
        track_obs=z["track_obs"],
    )


def stage_path(ckpt_dir: str, stage: str) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    return os.path.join(ckpt_dir, f"{stage}.npz")


def try_resume(ckpt_dir: Optional[str], stage: str):
    """Return the checkpointed SparseReconstruction if present, else None."""
    if not ckpt_dir:
        return None
    p = stage_path(ckpt_dir, stage)
    if os.path.exists(p):
        return load_sparse(p)
    return None


# ---------------------------------------------------------------------------
# Mid-MVS expansion state (round-boundary checkpointing)
# ---------------------------------------------------------------------------

MVS_STATE_FILE = "mvs_state.npz"


def save_mvs_state(ckpt_dir: str, state: dict) -> None:
    """Atomically persist mid-expansion MVS state.

    ``state`` maps flat string keys to numpy arrays / scalars (the pipeline
    flattens its frontier/backlog dicts with ``f_``/``b_`` prefixes).  Write
    to a temp file + rename so a crash mid-save never corrupts the previous
    checkpoint.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, MVS_STATE_FILE)
    tmp = path + ".tmp"
    np.savez_compressed(tmp, **state)
    # numpy appends .npz to names without it
    if not os.path.exists(tmp) and os.path.exists(tmp + ".npz"):
        tmp = tmp + ".npz"
    os.replace(tmp, path)


def load_mvs_state(ckpt_dir: Optional[str]) -> Optional[dict]:
    """Return the mid-expansion state dict if a checkpoint exists."""
    if not ckpt_dir:
        return None
    path = os.path.join(ckpt_dir, MVS_STATE_FILE)
    if not os.path.exists(path):
        return None
    with np.load(path, allow_pickle=False) as z:
        return {k: z[k] for k in z.files}


def clear_mvs_state(ckpt_dir: Optional[str]) -> None:
    if not ckpt_dir:
        return
    path = os.path.join(ckpt_dir, MVS_STATE_FILE)
    if os.path.exists(path):
        os.remove(path)
