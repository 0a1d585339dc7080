"""Two-view epipolar geometry: weighted normalized 8-point estimation and
Sampson residuals.  Counterpart of ``sfm_tpu/geometry/epipolar.py``.

The estimator takes a weight vector over correspondences, so minimal
8-point samples (one-hot weights, one row per RANSAC hypothesis) and the
all-inlier refit share one code path, batched over leading dimensions.
"""

from __future__ import annotations

import math

import torch

from sfm_tpu_torch.geometry.nullvec import smallest_eigvec

_EPS = 1e-12


def _normalize(pts, weights):
    """Hartley normalization: centroid to origin, mean distance sqrt(2).

    Returns (normalized points (..., N, 2), T (..., 3, 3))."""
    wsum = torch.clamp_min(torch.sum(weights, dim=-1, keepdim=True), _EPS)
    centroid = torch.sum(pts * weights[..., None], dim=-2) / wsum
    d = pts - centroid[..., None, :]
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    mean_dist = torch.sum(dist * weights, dim=-1) / wsum[..., 0]
    s = math.sqrt(2.0) / torch.clamp_min(mean_dist, _EPS)
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, zeros, -s * centroid[..., 0]], dim=-1),
            torch.stack([zeros, s, -s * centroid[..., 1]], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    return d * s[..., None, None], T


def eight_point(pts1, pts2, weights=None):
    """Weighted normalized 8-point fundamental-matrix estimate.

    pts1, pts2 (..., N, 2); weights (..., N) nonnegative (default ones).
    Returns (..., 3, 3) rank-2 F with unit Frobenius norm, x2^T F x1 ~ 0.
    """
    if weights is None:
        weights = torch.ones(pts1.shape[:-1], dtype=pts1.dtype,
                             device=pts1.device)
    n1, T1 = _normalize(pts1, weights)
    n2, T2 = _normalize(pts2, weights)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    A = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
         torch.ones_like(x1)],
        dim=-1,
    )
    A = A * weights[..., None]
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    f = smallest_eigvec(AtA)
    F = f.reshape(*f.shape[:-1], 3, 3)
    # Rank-2: with v3 the smallest right singular vector, F - (F v3) v3^T is
    # U diag(s1, s2, 0) V^T exactly — no SVD.
    FtF = torch.einsum("...ki,...kj->...ij", F, F)
    v3 = smallest_eigvec(FtF)
    F = F - torch.einsum("...ij,...j->...i", F, v3)[..., :, None] * v3[..., None, :]
    F = T2.transpose(-1, -2) @ F @ T1
    norm = torch.sqrt(torch.sum(F * F, dim=(-2, -1), keepdim=True))
    return F / torch.clamp_min(norm, _EPS)


def _homog(pts):
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def _lines(F, pts1, pts2):
    x1 = _homog(pts1)
    x2 = _homog(pts2)
    Fx1 = torch.einsum("...ij,...nj->...ni", F, x1)
    Ftx2 = torch.einsum("...ji,...nj->...ni", F, x2)
    return x2, Fx1, Ftx2


def sampson_distance(F, pts1, pts2):
    """First-order geometric (Sampson) distance, (..., N) in px^2."""
    x2, Fx1, Ftx2 = _lines(F, pts1, pts2)
    num = torch.sum(x2 * Fx1, dim=-1) ** 2
    den = (
        Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
        + Ftx2[..., 1] ** 2
    )
    return num / torch.clamp_min(den, _EPS)


def epipolar_distance(F, pts1, pts2):
    """Symmetric point-to-epiline distance in pixels, (..., N)."""
    x2, Fx1, Ftx2 = _lines(F, pts1, pts2)
    dot = torch.sum(x2 * Fx1, dim=-1).abs()
    d1 = dot / torch.clamp_min(torch.sqrt(Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2), _EPS)
    d2 = dot / torch.clamp_min(torch.sqrt(Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2), _EPS)
    return 0.5 * (d1 + d2)
