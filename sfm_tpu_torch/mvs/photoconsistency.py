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
Every sweep goes through K2s's launch step (``ops.gather.sample_shards``):
``photo_consistency(mesh=...)`` splits the candidates over a mesh's shards,
as the JAX package's mesh path does, and a call without a mesh is a mesh of
one shard.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.geometry.projection import project_pinhole
from sfm_tpu_torch.ops.gather import _sample_plain, sample_shards
from sfm_tpu_torch.ops.ncc import _inbounds
from sfm_tpu_torch.parallel.mesh import DataMesh


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


def _sweep(grays, imgs, pixs, wid: int, kernels):
    """Per shard, normalized descriptors (..., D) bf16 and in-bounds (...,)
    for shard i's samples (``imgs[i]`` (...,), ``pixs[i]`` (..., 2))
    against its replica ``grays[i]`` of the stack, on that shard's device.

    With kernels on this is K2s's launch step (``ops.gather.sample_shards``:
    one K2 launch per shard on a CUDA device).  K2's wrapper raises for a
    non-contiguous CUDA tensor, and the ungated sweep's image index is a
    broadcast view, so both inputs are made contiguous here.  No fallback:
    a failed build or launch raises.
    """
    imgs = [i.to(torch.int32).contiguous() for i in imgs]
    pixs = [p.to(torch.float32).contiguous() for p in pixs]
    if kernels is not False:
        return sample_shards(grays, imgs, pixs, wid)
    out = []
    for gray, img, pix in zip(grays, imgs, pixs):
        h, w = gray.shape[1], gray.shape[2]
        desc = _sample_plain(gray, img.reshape(-1), pix.reshape(-1, 2), wid)
        inb = _inbounds(pix[..., 0], pix[..., 1], h, w, wid)
        out.append((desc.reshape(*img.shape, -1), inb))
    return out


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
    min_ncc,         # float, or (M,) tensor: a threshold per candidate
    wid: int = 5,
    max_views: int = 0,
    kernels=None,
    mesh=None,
):
    """Score M candidates against all N views.

    ``min_ncc`` may be a per-candidate (M,) tensor: the outlier filter's
    recompute scores seeds and expansion patches in one batch, each with its
    own accept-time threshold.

    ``0 < max_views < N`` takes the geometric view gate (``_gated_samples``:
    the sweep runs over M x max_views samples instead of M x N); otherwise
    every view is scored, the reference's semantics.

    ``mesh`` (a ``parallel.DataMesh``; by default a mesh of ``centers``'s
    one device) splits the candidates over its shards: projection, view
    gate, K2 sweep (K2s's launch step) and NCC run per shard on the shard's
    device, and the results are gathered on the lead device, where
    ``centers`` and ``ref_idx`` lie.  ``gray``, K, R and t may be the
    per-shard lists of ``mesh.replicate``.  Each candidate is scored on its
    own, so the result is the same whatever the mesh.

    Returns:
      vis: (M, N) bool — view passes the NCC threshold (False at the ref view);
      proj: (M, N, 2) float32 — projected pixel of each candidate in each view;
      score_mean: (M,) mean NCC over visible views (0 if none);
      vis_count: (M,) int32 number of visible (non-reference) views.
    """
    mesh = mesh or DataMesh([centers.device])
    grays, Ks, Rs, ts = (mesh.replicate(x) for x in (gray, K, R, t))
    grays = [g.to(torch.bfloat16) for g in grays]
    cs, refs = mesh.split(centers), mesh.split(ref_idx)
    h, w = grays[0].shape[1], grays[0].shape[2]
    samples = [_view_samples(*args, h, w, wid, max_views)
               for args in zip(Ks, Rs, ts, cs, refs)]
    swept = _sweep(grays, [s[1] for s in samples], [s[2] for s in samples],
                   wid, kernels)
    if torch.is_tensor(min_ncc) and min_ncc.dim() == 1:
        thrs = [thr[:, None] for thr in mesh.split(min_ncc)]
    else:
        thrs = [min_ncc] * len(mesh.local_devices)
    outs = [
        _score(d, b, s, ref, thr, wid)
        for (d, b), s, ref, thr in zip(swept, samples, refs, thrs)
    ]
    m = centers.shape[0]
    return tuple(mesh.gather(list(x), m) for x in zip(*outs))


def _view_samples(K, R, t, centers, ref_idx, h_img: int, w_img: int,
                  wid: int, max_views: int):
    """The sweep's samples for a candidate batch: (proj (M, N, 2), img
    (M, V) view per sample, pix (M, V, 2) centre per sample, gate).  With
    the view gate (``0 < max_views < N``) V = max_views and gate is
    (top_idx, pick_ok) of ``_gated_samples``; otherwise every view is
    sampled (V = N) and gate is None."""
    n_img = K.shape[0]
    if 0 < max_views < n_img:
        proj, vidx, pix_v, top_idx, pick_ok = _gated_samples(
            K, R, t, centers, ref_idx, h_img, w_img, wid, max_views,
        )
        return proj, vidx, pix_v, (top_idx, pick_ok)
    m = centers.shape[0]
    proj = project_pinhole(centers[:, None, :], K[None], R[None], t[None])
    img_b = torch.arange(n_img, dtype=torch.int32, device=centers.device)
    return proj, img_b[None, :].expand(m, n_img), proj, None


def _score(desc, inb, samples, ref_idx, min_ncc, wid: int):
    """NCC against the reference view's descriptor, the visibility rule
    and the per-candidate counts, from the sweep of ``_view_samples``;
    ``min_ncc`` is a float or an (M, 1) column."""
    proj, img, _, gate = samples
    m, n_img = proj.shape[0], proj.shape[1]
    side2 = (2 * wid + 1) ** 2
    ncc_scale = side2 / (side2 - 1.0)
    if gate is None:
        ref = ref_idx.long()
        rows = torch.arange(m, device=proj.device)
        ncc = _ncc(desc, desc[rows, ref], ncc_scale)          # (M, N)
        not_ref = img.long() != ref[:, None]
        vis = (ncc > min_ncc) & inb & inb[rows, ref][:, None] & not_ref
        scores = torch.where(vis, ncc, torch.zeros_like(ncc))
        vis_count = vis.sum(dim=1, dtype=torch.int32)
        score_mean = scores.sum(dim=1) / torch.clamp_min(vis_count, 1)
        return vis, proj.to(torch.float32), score_mean, vis_count
    top_idx, pick_ok = gate
    ncc = _ncc(desc, desc[:, 0], ncc_scale)                   # (M, V)
    vis_v = (
        (ncc[:, 1:] > min_ncc) & inb[:, 1:] & inb[:, :1] & pick_ok
    )                                                         # (M, V-1)
    scores = torch.where(vis_v, ncc[:, 1:], torch.zeros_like(ncc[:, 1:]))
    vis_count = vis_v.sum(dim=1, dtype=torch.int32)
    score_mean = scores.sum(dim=1) / torch.clamp_min(vis_count, 1)
    vis = torch.zeros((m, n_img), dtype=torch.bool, device=proj.device)
    vis = vis.scatter(1, top_idx, vis_v)
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
