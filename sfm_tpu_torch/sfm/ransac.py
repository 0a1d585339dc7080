"""Batched RANSAC for fundamental-matrix estimation.

Counterpart of ``sfm_tpu/sfm/ransac.py``: a fixed batch of H minimal
8-point samples becomes one-hot weight rows, the weighted normalized
8-point solver runs on all hypotheses at once, every hypothesis scores every
correspondence by Sampson distance, and the best is refit on its inliers.
Leading batch dimensions (the pair axis) are carried throughout.

Random draws cannot be reproduced across frameworks, so the hypotheses are
given as ``samples``: the JAX package's own draws in the tests, or
``samples_from_uniforms`` of ``draw_uniforms`` (uniforms drawn from a
``torch.Generator``) (the pipeline draws them for all pairs at once, before
any split over a mesh).
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.geometry.epipolar import eight_point, sampson_distance
from sfm_tpu_torch.utils.metrics import span


def draw_uniforms(batch, num_hypotheses: int,
                  generator: torch.Generator) -> torch.Tensor:
    """(*batch, H*8) float64 uniform numbers from ``generator``, on the CPU
    (so a seed gives the same hypotheses on any device); the span ``draw``
    under the caller's open span (``pair_geometry.draw`` in SfM)."""
    with span("draw"):
        return torch.rand((*batch, num_hypotheses * 8), generator=generator,
                          dtype=torch.float64)


def samples_from_uniforms(valid: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Map uniforms u (..., H*8) in [0, 1) to (..., H, 8) indices of valid
    rows of ``valid`` (..., M).  A batch row without valid entries draws
    index 0 (its hypotheses score nothing: every correspondence is
    invalid)."""
    batch = valid.shape[:-1]
    u = u.to(valid.device)
    n_valid = valid.sum(dim=-1, keepdim=True)
    r = torch.minimum((u * n_valid).long(), torch.clamp_min(n_valid - 1, 0))
    # The r-th valid row: first position whose running count exceeds r.
    cum = torch.cumsum(valid.long(), dim=-1)
    idx = torch.searchsorted(cum.contiguous(), r + 1)
    idx = torch.where(n_valid > 0, idx, torch.zeros_like(idx))
    return idx.reshape(*batch, u.shape[-1] // 8, 8)


def ransac_fundamental(
    pts1,
    pts2,
    valid,
    samples: torch.Tensor,
    threshold_px: float = 2.0,
    refit: bool = True,
):
    """Robustly estimate F from padded correspondences.

    Args:
      pts1, pts2: (..., M, 2) float correspondence coordinates (padded).
      valid: (..., M) bool validity of each correspondence.
      samples: (..., H, 8) int64 correspondence indices, one row per
        hypothesis.
      threshold_px: inlier threshold on sqrt(Sampson distance), px.
      refit: re-estimate F from all inliers of the best hypothesis.

    Returns (F (..., 3, 3), inliers (..., M) bool, num_inliers (...,) int32).
    """
    samples = samples.to(pts1.device).long()
    m = pts1.shape[-2]
    h = samples.shape[-2]
    weights = torch.zeros((*samples.shape[:-1], m), dtype=pts1.dtype,
                          device=pts1.device)
    weights.scatter_(-1, samples, 1.0)  # (..., H, M) one-hot minimal samples
    P1 = pts1[..., None, :, :]
    P2 = pts2[..., None, :, :]
    F_h = eight_point(
        P1.expand(*pts1.shape[:-2], h, m, 2),
        P2.expand(*pts2.shape[:-2], h, m, 2),
        weights,
    )  # (..., H, 3, 3)
    d = sampson_distance(F_h, P1, P2)  # (..., H, M)
    thr2 = threshold_px * threshold_px
    inl = (d < thr2) & valid[..., None, :]
    best = torch.argmax(inl.sum(dim=-1), dim=-1)  # first of the ties
    F = torch.gather(
        F_h, -3, best[..., None, None, None].expand(*best.shape, 1, 3, 3)
    )[..., 0, :, :]
    inliers = torch.gather(
        inl, -2, best[..., None, None].expand(*best.shape, 1, m)
    )[..., 0, :]
    if refit:
        F_refit = eight_point(pts1, pts2, inliers.to(pts1.dtype))
        inl_refit = (sampson_distance(F_refit, pts1, pts2) < thr2) & valid
        # Keep the refit only if it does not lose inliers.
        better = inl_refit.sum(dim=-1) >= inliers.sum(dim=-1)
        F = torch.where(better[..., None, None], F_refit, F)
        inliers = torch.where(better[..., None], inl_refit, inliers)
    return F, inliers, inliers.sum(dim=-1, dtype=torch.int32)
