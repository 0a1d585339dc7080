"""Closed-form batched 3x3 solves (adjugate / Cramer), elementwise over any
leading batch dimensions.  Counterpart of ``sfm_tpu/geometry/linalg3.py``;
used by triangulation refinement."""

from __future__ import annotations

import torch


def _entries(M):
    return [[M[..., i, j] for j in range(3)] for i in range(3)]


def adjugate3(M):
    """Batched adjugate of (..., 3, 3)."""
    (a, b, c), (d, e, f), (g, h, i) = _entries(M)
    return torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        -2,
    )


def det3(M):
    (a, b, c), (d, e, f), (g, h, i) = _entries(M)
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _safe_det(M, eps):
    det = det3(M)
    return torch.where(det.abs() < eps, torch.full_like(det, eps), det)


def inv3(M, eps: float = 1e-30):
    """Batched closed-form inverse of (..., 3, 3)."""
    return adjugate3(M) / _safe_det(M, eps)[..., None, None]


def solve3(M, b, eps: float = 1e-30):
    """Solve (..., 3, 3) @ x = (..., 3) in closed form."""
    x = torch.einsum("...ij,...j->...i", adjugate3(M), b)
    return x / _safe_det(M, eps)[..., None]
