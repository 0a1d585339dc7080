"""Batched multi-view photo-consistency (NCC) scoring.

Counterpart of ``sfm_tpu/mvs/photoconsistency.py``.  A batch of candidate
patch centres is projected into every view (each with its own camera),
normalized 11x11 descriptors are sampled bilinearly at the fractional
projections, and NCC against the reference view's descriptor decides
visibility.  Score convention: Pearson correlation scaled by n/(n-1), so
the reference's 0.4/0.7 thresholds carry over; the reference view itself
is never in the visible set.

The sampling sweep is kernel K2 (ops/gather.py: ``sample_normalized_patches``
on CUDA tensors; its plain version on CPU tensors, through the same
wrapper).  ``kernels=False`` runs the plain version on any device, a
measurement switch.  Descriptors are bf16, as in the JAX package.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.geometry.projection import project_pinhole
from sfm_tpu_torch.ops.gather import _sample_plain, sample_normalized_patches
from sfm_tpu_torch.ops.ncc import _inbounds


def pack_patch_payload(c, n, score, ref_pix, ref_idx, valid):
    """Fuse the per-patch host-bound outputs into one (M, 11) float32 tensor,
    [c(3) | n(3) | score | u | v | ref | valid], so the host reads a whole
    round in one copy; (u, v) is the patch's projection in its reference
    view, where the host samples its color."""
    f = torch.float32
    return torch.cat(
        [
            c.to(f),
            n.to(f),
            score.to(f)[:, None],
            ref_pix.to(f),
            ref_idx.to(f)[:, None],
            valid.to(f)[:, None],
        ],
        dim=1,
    )


def unpack_patch_payload(ph, images):
    """Host-side decode of ``pack_patch_payload`` rows (numpy).

    Returns (valid mask, c, n, score, colors uint8) with colors sampled
    nearest-pixel from ``images`` at each patch's reference projection.
    """
    h, w = images.shape[1], images.shape[2]
    valid = ph[:, 10] > 0.5
    x = np.clip(np.rint(ph[:, 7]).astype(np.int64), 0, w - 1)
    y = np.clip(np.rint(ph[:, 8]).astype(np.int64), 0, h - 1)
    ref = np.clip(ph[:, 9].astype(np.int64), 0, images.shape[0] - 1)
    colors = images[ref, y, x]
    return valid, ph[:, 0:3], ph[:, 3:6], ph[:, 6], colors


def _top_k(x, k: int):
    """``jax.lax.top_k`` along the last axis: the k largest values, and
    among equal values the lower index first (a stable descending sort;
    ``torch.topk`` orders ties differently)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _sweep(gray, img_idx, pix, wid: int, kernels):
    """Normalized descriptors (..., D) bf16 and in-bounds (...,) for samples
    (img_idx (...,), pix (..., 2)).

    K2's wrapper raises for a non-contiguous CUDA tensor, and the ungated
    sweep's image index is a broadcast view, so both inputs are made
    contiguous here.  No fallback: a failed build or launch raises.
    """
    img_idx = img_idx.to(torch.int32).contiguous()
    pix = pix.to(torch.float32).contiguous()
    if kernels is not False:
        return sample_normalized_patches(gray, img_idx, pix, wid)
    h, w = gray.shape[1], gray.shape[2]
    desc = _sample_plain(gray, img_idx.reshape(-1), pix.reshape(-1, 2), wid)
    inb = _inbounds(pix[..., 0], pix[..., 1], h, w, wid)
    return desc.reshape(*img_idx.shape, -1), inb


def _ncc(desc, ref_desc, ncc_scale: float):
    """NCC of bf16 descriptors (M, V, D) against (M, D), in f32.

    ``torch.einsum`` on two bf16 tensors returns bf16, which would round
    every NCC before the 0.4/0.7 thresholds; the JAX package contracts bf16
    with an f32 result.  Products of bf16 values are exact in f32, so the
    operands are cast to f32 first (TF32 stays off, sfm_tpu_torch/__init__).
    """
    return torch.einsum("mvd,md->mv", desc.float(), ref_desc.float()) * ncc_scale


def photo_consistency(
    gray,            # (N, H, W) bfloat16 grayscale stack (other floats are cast)
    K, R, t,         # (N, 3, 3), (N, 3, 3), (N, 3) float32 calibration
    centers,         # (M, 3) candidate patch centroids
    ref_idx,         # (M,) int reference image per candidate
    min_ncc: float,
    wid: int = 5,
    max_views: int = 0,
    kernels=None,
):
    """Score M candidates against all N views.

    ``0 < max_views < N`` takes the geometric view gate
    (``_photo_consistency_gated``); otherwise every view is scored, the
    reference's semantics.

    Returns:
      vis: (M, N) bool — view passes the NCC threshold (False at the ref view);
      proj: (M, N, 2) float32 — projected pixel of each candidate in each view;
      score_mean: (M,) mean NCC over visible views (0 if none);
      vis_count: (M,) int32 number of visible (non-reference) views.
    """
    if gray.dtype != torch.bfloat16:
        gray = gray.to(torch.bfloat16)
    n_img = gray.shape[0]
    if 0 < max_views < n_img:
        return _photo_consistency_gated(
            gray, K, R, t, centers, ref_idx, min_ncc, wid, max_views, kernels,
        )
    m = centers.shape[0]
    side2 = (2 * wid + 1) ** 2
    ncc_scale = side2 / (side2 - 1.0)
    ref = ref_idx.long()
    rows = torch.arange(m, device=centers.device)

    proj = project_pinhole(centers[:, None, :], K[None], R[None], t[None])
    img_b = torch.arange(n_img, dtype=torch.int32, device=centers.device)
    desc, inb = _sweep(gray, img_b[None, :].expand(m, n_img), proj, wid, kernels)
    ncc = _ncc(desc, desc[rows, ref], ncc_scale)             # (M, N)
    not_ref = img_b[None, :].long() != ref[:, None]
    vis = (ncc > min_ncc) & inb & inb[rows, ref][:, None] & not_ref
    scores = torch.where(vis, ncc, torch.zeros_like(ncc))
    vis_count = vis.sum(dim=1, dtype=torch.int32)
    score_mean = scores.sum(dim=1) / torch.clamp_min(vis_count, 1)
    return vis, proj.to(torch.float32), score_mean, vis_count


def _gated_samples(K, R, t, centers, ref_idx, h_img: int, w_img: int,
                   wid: int, max_views: int):
    """The view gate's sample list.  Per candidate, the non-reference views
    that are in frame, in front of the camera and best aligned with the
    patch normal (computed from geometry alone), after the reference view.

    Returns (proj (M, N, 2), vidx (M, V) view per sample, pix_v (M, V, 2)
    centre per sample, top_idx (M, V-1), pick_ok (M, V-1) bool).
    """
    n_img = K.shape[0]
    m = centers.shape[0]
    ref = ref_idx.long()
    rows = torch.arange(m, device=centers.device)
    proj = project_pinhole(centers[:, None, :], K[None], R[None], t[None])
    depth = (torch.einsum("nij,mj->mni", R, centers) + t[None])[..., 2]
    cam_centers = -torch.einsum("nji,nj->ni", R, t)         # (N, 3) = -R^T t
    dirs = cam_centers[None] - centers[:, None]               # (M, N, 3)
    dirs = dirs / torch.clamp_min(
        torch.sqrt(torch.sum(dirs * dirs, dim=-1, keepdim=True)), 1e-12
    )
    normal = dirs[rows, ref]                                  # toward ref cam
    cos_ang = torch.einsum("mni,mi->mn", dirs, normal)
    inframe = (
        (proj[..., 0] >= wid + 1)
        & (proj[..., 0] <= w_img - wid - 2)
        & (proj[..., 1] >= wid + 1)
        & (proj[..., 1] <= h_img - wid - 2)
        & (depth > 0)
    )
    not_ref = torch.arange(n_img, device=centers.device)[None, :] != ref[:, None]
    pref = torch.where(
        inframe & not_ref, cos_ang, torch.full_like(cos_ang, -float("inf"))
    )
    top_pref, top_idx = _top_k(pref, max_views - 1)          # (M, V-1)
    vidx = torch.cat([ref[:, None], top_idx], dim=1)         # (M, V)
    pix_v = torch.gather(proj, 1, vidx[..., None].expand(m, max_views, 2))
    return proj, vidx, pix_v, top_idx, torch.isfinite(top_pref)


def _photo_consistency_gated(
    gray, K, R, t, centers, ref_idx, min_ncc, wid: int, max_views: int,
    kernels=None,
):
    """Top-(max_views-1) geometric view selection + one stacked sweep.

    Same contract as ``photo_consistency``; the sweep runs over
    M x max_views samples (``_gated_samples``) instead of M x N.
    """
    n_img = gray.shape[0]
    m = centers.shape[0]
    side2 = (2 * wid + 1) ** 2
    ncc_scale = side2 / (side2 - 1.0)
    proj, vidx, pix_v, top_idx, pick_ok = _gated_samples(
        K, R, t, centers, ref_idx, gray.shape[1], gray.shape[2], wid,
        max_views,
    )
    desc, inb_v = _sweep(gray, vidx, pix_v, wid, kernels)    # (M, V, D) bf16
    ncc = _ncc(desc, desc[:, 0], ncc_scale)                   # (M, V)
    vis_v = (
        (ncc[:, 1:] > min_ncc) & inb_v[:, 1:] & inb_v[:, :1] & pick_ok
    )                                                         # (M, V-1)
    scores = torch.where(vis_v, ncc[:, 1:], torch.zeros_like(ncc[:, 1:]))
    vis_count = vis_v.sum(dim=1, dtype=torch.int32)
    score_mean = scores.sum(dim=1) / torch.clamp_min(vis_count, 1)
    vis = torch.zeros((m, n_img), dtype=torch.bool, device=centers.device)
    vis = vis.scatter(1, top_idx, vis_v)
    return vis, proj.to(torch.float32), score_mean, vis_count
