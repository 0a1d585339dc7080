"""Descriptor matching, batched over image pairs.

Counterpart of ``sfm_tpu/features/matching.py``: one correlation product per
pair, the Lowe ratio test on unit-vector distances (d^2 = 2 - 2 s), a
mutual-nearest check from argmaxes along both axes, and compaction of the
accepted rows to ``max_matches`` slots with a validity mask.  Every tensor
may carry leading batch dimensions (the pair axis).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from sfm_tpu_torch.ops.ncc import ncc_scores

_NEG = -2.0  # below any valid NCC score (range [-1, 1])


@dataclass
class MatchResult:
    """Static-capacity match sets.

    idx1/idx2: (..., M) int32 indices into each FeatureSet's corners;
    valid: (..., M) bool; count: (...,) int32 number of valid matches.
    """

    idx1: torch.Tensor
    idx2: torch.Tensor
    valid: torch.Tensor
    count: torch.Tensor


def match_descriptors(
    desc1,
    valid1,
    desc2,
    valid2,
    lowe_ratio: float = 0.8,
    max_matches: int = 2048,
    mutual_check: bool = True,
) -> MatchResult:
    """Match (..., K1, D) against (..., K2, D); indices padded to max_matches."""
    s = ncc_scores(desc1, desc2)  # (..., K1, K2)
    s = torch.where(valid1[..., :, None] & valid2[..., None, :], s,
                    torch.full_like(s, _NEG))
    k1, k2 = s.shape[-2], s.shape[-1]
    # argmax returns the first maximal index in both frameworks.
    best = torch.amax(s, dim=-1)
    j_best = torch.argmax(s, dim=-1)
    cols = torch.arange(k2, device=s.device)
    masked = torch.where(cols == j_best[..., None], torch.full_like(s, _NEG), s)
    second = torch.amax(masked, dim=-1)
    r2 = lowe_ratio * lowe_ratio
    d1 = torch.clamp_min(1.0 - best, 0.0)
    d2 = torch.clamp_min(1.0 - second, 0.0)
    accept = (d1 < r2 * d2) & valid1 & (best > _NEG + 1.0)
    if mutual_check:
        col_best = torch.argmax(s, dim=-2)  # (..., K2)
        rows = torch.arange(k1, device=s.device)
        accept = accept & (torch.gather(col_best, -1, j_best) == rows)
    score = torch.where(accept, best, torch.full_like(best, _NEG))
    # Stable descending sort = jax.lax.top_k's tie order (lower index first).
    vals, rows = torch.sort(score, dim=-1, descending=True, stable=True)
    m = min(max_matches, k1)
    vals, rows = vals[..., :m], rows[..., :m]
    if m < max_matches:
        pad = [0, max_matches - m]
        vals = torch.nn.functional.pad(vals, pad, value=_NEG)
        rows = torch.nn.functional.pad(rows, pad, value=0)
    ok = vals > _NEG
    return MatchResult(
        idx1=rows.to(torch.int32),
        idx2=torch.gather(j_best, -1, rows).to(torch.int32),
        valid=ok,
        count=ok.sum(dim=-1, dtype=torch.int32),
    )


def matched_points(corners1, corners2, match: MatchResult):
    """(..., M, 2) float32 pixel coordinates of each match in both images,
    gathered from (..., K, 2) corners by ``match.idx1`` / ``match.idx2``."""

    def take(cor, idx):
        idx = idx.long()
        return torch.gather(cor, -2, idx[..., None].expand(*idx.shape, 2)).float()

    return take(corners1, match.idx1), take(corners2, match.idx2)


def match_pair_gate(match: MatchResult, min_matches: int = 8):
    """(...,) bool: pairs with at least ``min_matches`` matches (the
    reference skips the others)."""
    return match.count >= min_matches
