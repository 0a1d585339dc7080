"""Rotation representations (axis-angle <-> matrix), batched over leading
dimensions.  Counterpart of ``sfm_tpu/geometry/rotations.py``: the same
formulas, including the second-order Taylor branch near theta = 0 and the
symmetric-part fallback near theta = pi."""

from __future__ import annotations

import math

import torch

_EPS = 1e-12


def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate_points(points, rotvecs):
    """Rotate ``points`` (..., 3) by axis-angle ``rotvecs`` (..., 3).

    Rodrigues: v' = v cos t + (k x v) sin t + k (k . v)(1 - cos t); the
    t -> 0 neighbourhood takes v + w x v + 0.5 w x (w x v).
    """
    theta2 = torch.sum(rotvecs * rotvecs, dim=-1, keepdim=True)
    small = theta2 < 1e-14
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    k = rotvecs / theta
    cos = torch.cos(theta)
    sin = torch.sin(theta)
    dot = torch.sum(k * points, dim=-1, keepdim=True)
    main = points * cos + _cross(k, points) * sin + k * dot * (1.0 - cos)
    cross_w = _cross(rotvecs, points)
    taylor = points + cross_w + 0.5 * _cross(rotvecs, cross_w)
    return torch.where(small, taylor, main)


def rodrigues_matrix(rotvecs):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta = torch.sqrt(torch.sum(rotvecs * rotvecs, dim=-1, keepdim=True))
    k = rotvecs / torch.clamp_min(theta, _EPS)
    kx, ky, kz = k[..., 0], k[..., 1], k[..., 2]
    zeros = torch.zeros_like(kx)
    K = torch.stack(
        [
            torch.stack([zeros, -kz, ky], dim=-1),
            torch.stack([kz, zeros, -kx], dim=-1),
            torch.stack([-ky, kx, zeros], dim=-1),
        ],
        dim=-2,
    )
    theta = theta[..., None]
    eye = torch.eye(3, dtype=rotvecs.dtype, device=rotvecs.device)
    return eye + torch.sin(theta) * K + (1.0 - torch.cos(theta)) * (K @ K)


def rodrigues_vector(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), theta in [0, pi]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos)
    ax = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin = torch.sin(theta)
    small = theta[..., None] < 1e-6
    near_pi = (math.pi - theta[..., None]) < 1e-4
    axis_gen = ax / torch.clamp_min(2.0 * sin[..., None], _EPS)
    # theta -> pi: axis from the largest column of R + I, sign taken from
    # the antisymmetric part where it still carries it.
    M = R + torch.eye(3, dtype=R.dtype, device=R.device)
    col_norms = torch.sqrt(torch.sum(M * M, dim=-2))
    best = torch.argmax(col_norms, dim=-1)
    idx = best[..., None, None].expand(*M.shape[:-1], 1)
    col = torch.gather(M, -1, idx)[..., 0]
    axis_pi = col / torch.clamp_min(
        torch.sqrt(torch.sum(col * col, dim=-1, keepdim=True)), _EPS
    )
    sign = torch.where(
        torch.sum(axis_pi * ax, dim=-1, keepdim=True) < 0.0, -1.0, 1.0
    )
    axis = torch.where(near_pi, axis_pi * sign, axis_gen)
    rv = axis * theta[..., None]
    return torch.where(small, ax * 0.5, rv)
