"""Bundle-adjustment residual model and exact Jacobian blocks.

Counterpart of ``sfm_tpu/ba/model.py``: the 12-parameter camera
[rvec(3), t(3), fx, fy, k1, k2, px, py] (geometry.projection.project_cam),
residuals (projected - observed) per observation, and per-observation
Jacobian blocks dr/dcam (2x12) and dr/dpoint (2x3).

The JAX package takes the blocks from ``jax.jacfwd`` vmapped over
observations.  Here they are written in closed form: ``torch.func``'s
first call in a process imports torch.distributed's tensor-op tables,
dynamo and sympy (9.8 s for the first BA call on the host of an NVIDIA
H100 80GB HBM3 at 700 W, more than the rest of the pipeline), and the
closed form is a few batched elementwise ops.  Same
function, same two branches as ``geometry.rotations.rotate_points``
(Rodrigues, and the second-order Taylor form for theta^2 < 1e-14), held to
the JAX blocks at 1e-10 in tests/test_torch_ba.py.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.geometry.projection import _EPS, project_cam
from sfm_tpu_torch.geometry.rotations import rotate_points


def residuals(cams, points, cam_idx, point_idx, obs_2d, mask=None):
    """Per-observation residuals (O, 2); masked rows are zero."""
    r = project_cam(points[point_idx.long()], cams[cam_idx.long()]) - obs_2d
    if mask is not None:
        r = r * mask[:, None].to(r.dtype)
    return r


def total_cost(cams, points, cam_idx, point_idx, obs_2d, mask=None):
    """0.5 * sum of squared residuals (scipy least_squares convention);
    a 0-dim tensor on the inputs' device."""
    r = residuals(cams, points, cam_idx, point_idx, obs_2d, mask)
    return 0.5 * torch.sum(r * r)


def _skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]x."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
         torch.stack([-y, x, o], -1)], -2,
    )


def _rotation_jacobians(w, v):
    """For P = rotate_points(v, w): dP/dv = R(w) and dP/dw, both (..., 3, 3).

    Rodrigues branch: R = cos I + sin [k]x + (1 - cos) k k^T (k = w / theta)
    and dP/dw = -R [v]x (w w^T + (R^T - I) [w]x) / theta^2 (Gallego & Yezzi,
    "A compact formula for the derivative of a 3-D rotation in exponential
    coordinates", 2015).  Taylor branch (theta^2 < 1e-14): R = I + W + W^2/2
    and dP/dw = -[v]x + (w v^T + (w . v) I - 2 v w^T) / 2.
    """
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < 1e-14
    theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2)
    k = w / theta[..., 0]
    cos, sin = torch.cos(theta), torch.sin(theta)
    W, V = _skew(w), _skew(v)
    R_main = cos * eye + sin * _skew(k) + (1.0 - cos) * (k[..., :, None] * k[..., None, :])
    R_taylor = eye + W + 0.5 * (W @ W)
    d_main = -(R_main @ V) @ (
        w[..., :, None] * w[..., None, :] + (R_main.transpose(-1, -2) - eye) @ W
    ) / theta2
    wv = torch.sum(w * v, dim=-1)[..., None, None]
    d_taylor = -V + 0.5 * (
        w[..., :, None] * v[..., None, :] + wv * eye - 2.0 * v[..., :, None] * w[..., None, :]
    )
    return torch.where(small, R_taylor, R_main), torch.where(small, d_taylor, d_main)


def jacobian_blocks(cams, points, cam_idx, point_idx, obs_2d, mask=None):
    """Exact Jacobian blocks per observation.

    Returns (Jc (O, 2, 12), Jp (O, 2, 3), r (O, 2)), all zeroed on masked
    rows so padded observations contribute nothing to any normal equation.
    """
    c = cams[cam_idx.long()]
    p = points[point_idx.long()]
    r = project_cam(p, c) - obs_2d

    w, f = c[:, 0:3], c[:, 6:8]
    k1, k2 = c[:, 8:9], c[:, 9:10]
    P = rotate_points(p, w) + c[:, 3:6]
    z = P[:, 2:3]
    live = z.abs() >= _EPS              # project_cam's guarded z is a constant
    zs = torch.where(live, z, torch.full_like(z, _EPS))
    xy = P[:, :2] / zs
    n = torch.sum(xy * xy, dim=-1, keepdim=True)
    rad = 1.0 + k1 * n + k2 * n * n
    # d(xy)/dP (O, 2, 3)
    inv_z = 1.0 / zs
    zero = torch.zeros_like(inv_z)
    dz = torch.where(live, -xy * inv_z, torch.zeros_like(xy))
    dxy = torch.stack(
        [torch.cat([inv_z, zero, dz[:, 0:1]], -1),
         torch.cat([zero, inv_z, dz[:, 1:2]], -1)], 1,
    )
    # d(xy * rad)/d(xy) = rad I + 2 (k1 + 2 k2 n) xy xy^T, then scale by f.
    eye2 = torch.eye(2, dtype=r.dtype, device=r.device)
    M = rad[..., None] * eye2 + (2.0 * (k1 + 2.0 * k2 * n))[..., None] * (
        xy[:, :, None] * xy[:, None, :]
    )
    A = f[:, :, None] * (M @ dxy)                       # dr/dP (O, 2, 3)
    R, dRv_dw = _rotation_jacobians(w, p)
    Jp = A @ R
    Jc = torch.cat(
        [A @ dRv_dw, A, torch.diag_embed(xy * rad), (xy * n * f)[..., None],
         (xy * n * n * f)[..., None], eye2.expand(r.shape[0], 2, 2)],
        dim=-1,
    )                                   # [rvec | t | fx, fy | k1 | k2 | px, py]
    if mask is not None:
        m = mask.to(r.dtype)
        r = r * m[:, None]
        Jc = Jc * m[:, None, None]
        Jp = Jp * m[:, None, None]
    return Jc, Jp, r
