"""BA problem assembly from a sparse reconstruction.

Counterpart of ``sfm_tpu/ba/problem.py``: tracks flattened into
observation arrays and cameras packed as 12-parameter vectors, padded like
the JAX package's (observations and points to multiples of 1024, cameras
to multiples of 8) so the arrays of the two packages compare one to one.
Padding is inert: pad observations are masked, pad points and cameras have
no observations.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sfm_tpu_torch.geometry.projection import pack_cam
from sfm_tpu_torch.geometry.rotations import rodrigues_vector
from sfm_tpu_torch.io.calib import Calibration


@dataclass
class BAProblem:
    """Padded bundle-adjustment problem, tensors on one device.

    cams: (N, 12) float; points: (T, 3) float;
    cam_idx/point_idx: (O,) int32; obs_2d: (O, 2) float; mask: (O,) bool.
    Padded observations have mask=False and index 0.
    """

    cams: torch.Tensor
    points: torch.Tensor
    cam_idx: torch.Tensor
    point_idx: torch.Tensor
    obs_2d: torch.Tensor
    mask: torch.Tensor

    @classmethod
    def from_numpy(cls, cams, points, cam_idx, point_idx, obs_2d, mask,
                   dtype=torch.float64, device="cpu") -> "BAProblem":
        """Build from numpy arrays, e.g. the fields of ``sfm_tpu``'s
        BAProblem, so both packages solve the same problem."""
        def f(a):
            return torch.tensor(np.asarray(a), dtype=dtype, device=device)

        def i(a):
            return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)

        return cls(
            cams=f(cams), points=f(points), cam_idx=i(cam_idx),
            point_idx=i(point_idx), obs_2d=f(obs_2d),
            mask=torch.tensor(np.asarray(mask, bool), device=device),
        )

    @property
    def num_observations(self) -> int:
        return int(self.mask.sum())


def _pad_len(n: int, multiple: int) -> int:
    return ((max(n, 1) + multiple - 1) // multiple) * multiple


def build_problem(
    calib: Calibration,
    world: np.ndarray,
    track_offsets: np.ndarray,
    track_obs: np.ndarray,
    dtype=torch.float32,
    pad_to: int = 1024,
    pad_points_to: int = 1024,
    pad_cams_to: int = 8,
    device="cpu",
) -> BAProblem:
    """Flatten tracks into a padded BAProblem on ``device``.

    Args mirror SparseReconstruction.{world, track_offsets, track_obs}.
    Camera vectors are packed in float64 (pad cameras: identity rotation,
    zero translation) and then cast to ``dtype``.
    """
    n_tracks = world.shape[0]
    n_obs = track_obs.shape[0]
    lengths = np.diff(track_offsets)
    point_idx = np.repeat(np.arange(n_tracks, dtype=np.int64), lengths)
    cam_idx = track_obs[:, 0].astype(np.int64)
    obs_2d = track_obs[:, 1:3].astype(np.float64)

    n_views = calib.num_views
    K_h, R_h, t_h = calib.K, calib.R, calib.t
    if pad_cams_to > 1:
        c_pad = _pad_len(n_views, pad_cams_to) - n_views
        if c_pad:
            K_h = np.concatenate([K_h, np.tile(np.eye(3), (c_pad, 1, 1))])
            R_h = np.concatenate([R_h, np.tile(np.eye(3), (c_pad, 1, 1))])
            t_h = np.concatenate([t_h, np.zeros((c_pad, 3))])
    K_t, R_t, t_t = (torch.from_numpy(np.asarray(a, np.float64)) for a in (K_h, R_h, t_h))
    cams = pack_cam(K_t, rodrigues_vector(R_t), t_t).numpy()
    points = np.asarray(world, np.float64)
    if pad_points_to > 1:
        t_pad = _pad_len(n_tracks, pad_points_to) - n_tracks
        if t_pad:
            points = np.concatenate([points, np.zeros((t_pad, 3))])

    o_pad = _pad_len(n_obs, pad_to)
    pad = o_pad - n_obs
    mask = np.concatenate([np.ones(n_obs, bool), np.zeros(pad, bool)])
    point_idx = np.concatenate([point_idx, np.zeros(pad, np.int64)])
    cam_idx = np.concatenate([cam_idx, np.zeros(pad, np.int64)])
    obs_2d = np.concatenate([obs_2d, np.zeros((pad, 2))])
    return BAProblem.from_numpy(
        cams, points, cam_idx, point_idx, obs_2d, mask, dtype=dtype,
        device=device,
    )
