"""The benchmark's plain reference: sparse SfM, bundle adjustment and
dense MVS worked out again from the images, the calibration and the RANSAC
draws that the program is handed, stage by stage: SfM from the images, BA and MVS
from a given set of tracks (the program's own, when a pass is judged).

A frozen copy of the plain (kernel-free, single-device) paths of
``sfm_tpu_torch`` at commit bfc7f14, so that later changes to the program
cannot move it.  Plain PyTorch and NumPy: it imports neither ``jax`` nor
``sfm_tpu`` nor anything of ``sfm_tpu_torch``.  Of what the program made it
takes only the tracks a judged pass produced, as the input of its own BA
and MVS stages, so that those stages are judged on their own; the SfM
stage that made the tracks is judged against ``sparse_stage``.  It computes in the precisions the program states: float32
with TF32 off, descriptors rounded to bf16 as kernel K2 writes them, BA in
the configuration's dtype.  ``control=True`` computes one step below each,
the control that a correct comparison has to reject: TF32 products, float8
e4m3 descriptors, BA in bfloat16.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from sfmref.ba import bundle_adjust
from sfmref.mvs import dense_reconstruction
from sfmref.sparse import gray_stack, sparse_reconstruction


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 on or off for every float32 matrix product in the body, the
    previous setting restored after it."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def _cams(K, R, t, device):
    return tuple(torch.from_numpy(a.astype(np.float32)).to(device)
                 for a in (K, R, t))


def sparse_stage(images: np.ndarray, K: np.ndarray, R: np.ndarray,
                 t: np.ndarray, params: dict, job: dict, uniforms, device,
                 control: bool = False) -> dict:
    """Tracks of uint8 RGB ``images`` (N, H, W, 3) with exact float64
    cameras K, R, t on ``device``: ``world`` (T, 3) float64, ``offsets``
    (T+1,), ``obs`` (O, 3) rows (image, x, y).

    ``params`` holds the configuration's sections (features, ransac, sfm,
    ba, mvs); ``job`` the cell's ``pair_mode``, ``refine_cameras``,
    ``mvs_scale`` and ``stages``; ``uniforms`` (pairs, H*8) float64 the
    RANSAC draws.  ``control`` computes one step below the stated
    precision: TF32 products and float8 e4m3 descriptors."""
    device = torch.device(device)
    with matmul_precision(control):
        gray = gray_stack(images, device)
        world, offsets, obs = sparse_reconstruction(
            gray, *_cams(K, R, t, device), params, job["pair_mode"],
            uniforms, fp8=control)
    return {"world": world, "offsets": offsets, "obs": obs}


def ba_stage(K, R, t, tracks: dict, params: dict, job: dict, device,
             control: bool = False) -> np.ndarray:
    """The refined points (T, 3) float64 of ``tracks`` (``world``,
    ``offsets``, ``obs``), in the configuration's BA precision, or in
    bfloat16 (factorisations in float32) with TF32 products under
    ``control``."""
    bc = dict(params["ba"], refine_cameras=job["refine_cameras"])
    if control:
        bc["dtype"] = "bfloat16"
    with matmul_precision(control):
        return bundle_adjust(K, R, t, tracks["world"], tracks["offsets"],
                             tracks["obs"], bc, torch.device(device))


def mvs_stage(images: np.ndarray, K, R, t, tracks: dict, params: dict,
              job: dict, device, control: bool = False):
    """The dense cloud grown from ``tracks``: (points (D, 3) float32,
    normals (D, 3) float32); ``control`` samples float8 e4m3 descriptors
    with TF32 products."""
    device = torch.device(device)
    mc = dict(params["mvs"], fp8_descriptors=control)
    with matmul_precision(control):
        gray = gray_stack(images, device)
        centers = -np.einsum("nji,nj->ni", R, t)
        points, normals, _ = dense_reconstruction(
            images, gray, *_cams(K, R, t, device),
            torch.from_numpy(centers.astype(np.float32)).to(device),
            tracks["offsets"], tracks["obs"], tracks["world"].shape[0], mc,
            job["mvs_scale"])
    return points, normals
