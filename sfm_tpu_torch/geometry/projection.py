"""Camera projection models (pinhole P = K [R|t], and the 12-parameter BA
camera [rvec(3), t(3), fx, fy, k1, k2, px, py]).  Counterpart of
``sfm_tpu/geometry/projection.py``, batched over leading dimensions."""

from __future__ import annotations

import torch

from sfm_tpu_torch.geometry.rotations import rotate_points

_EPS = 1e-12
CAM_PARAMS = 12


def _safe_z(cam):
    z = cam[..., 2:3]
    return torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)


def projection_matrix(K, R, t):
    """(...,3,3),(...,3,3),(...,3) -> (...,3,4) P = K [R|t]."""
    return K @ torch.cat([R, t[..., :, None]], dim=-1)


def project_pinhole(points, K, R, t):
    """Project world points (..., 3) with pinhole cameras -> pixels (..., 2)."""
    cam = torch.einsum("...ij,...j->...i", R, points) + t
    ndc = cam[..., :2] / _safe_z(cam)
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    skew = K[..., 0, 1]
    u = fx * ndc[..., 0] + skew * ndc[..., 1] + cx
    v = fy * ndc[..., 1] + cy
    return torch.stack([u, v], dim=-1)


def pack_cam(K, R_rotvec, t):
    """12-param BA camera vector [rvec, t, fx, fy, k1=0, k2=0, px, py]."""
    fx = K[..., 0, 0]
    zeros = torch.zeros_like(fx)
    return torch.cat(
        [
            R_rotvec, t, fx[..., None], K[..., 1, 1][..., None],
            zeros[..., None], zeros[..., None],
            K[..., 0, 2][..., None], K[..., 1, 2][..., None],
        ],
        dim=-1,
    )


def project_cam(points, cams):
    """Project points (..., 3) with 12-param cameras (..., 12) -> (..., 2):
    rotate, translate, divide, radial r = 1 + k1 n + k2 n^2, scale, shift."""
    cam = rotate_points(points, cams[..., 0:3]) + cams[..., 3:6]
    xy = cam[..., :2] / _safe_z(cam)
    n = torch.sum(xy * xy, dim=-1, keepdim=True)
    k1 = cams[..., 8:9]
    k2 = cams[..., 9:10]
    r = 1.0 + k1 * n + k2 * n * n
    return xy * r * cams[..., 6:8] + cams[..., 10:12]


def reprojection_errors(points, pixels, K, R, t):
    """Per-observation Euclidean reprojection error in pixels."""
    d = project_pinhole(points, K, R, t) - pixels
    return torch.sqrt(torch.sum(d * d, dim=-1))
