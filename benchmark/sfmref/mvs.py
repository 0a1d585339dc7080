"""Plain dense reconstruction of the reference: occupancy cells,
photo-consistency by bilinear normalized patches and NCC, seeding from the
tracks, and frontier expansion rounds in the serial host loop.

A frozen copy of ``sfm_tpu_torch/mvs/`` (``cells.py``,
``photoconsistency.py``, ``seed.py``, ``expand.py``, ``pipeline.py``) and of
``ops/ncc.py`` / ``ops/gather.py``'s plain sampler at commit bfc7f14, for
one device: one round a call, each round's payload read before the next is
enqueued, no checkpoint and no outlier filter.  Descriptors are bf16 as in
the program's plain sampler.  Plain PyTorch and NumPy; imports nothing of
the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sfmref.geometry import (
    backproject_pixel,
    project_pinhole,
    projection_matrix,
    ray_plane_intersection,
    refine_triangulation,
    triangulate_dlt,
)
from sfmref.sparse import descriptor_values, normalize_descriptors

_BIG = 1e30  # f32(1e30), the "no passing candidate" distance key
_INT32_MAX = int(np.iinfo(np.int32).max)
_FRONTIER_KEYS = ("c", "n", "vis", "proj", "valid")


def resolve_photo_views(max_photo_views: int, n_images: int) -> int:
    """-1 (auto) -> 5 on rigs of >= 16 images, else 0 (every view)."""
    if max_photo_views == 1:
        raise ValueError("max_photo_views=1 leaves no view to score")
    if max_photo_views < 0:
        return 5 if n_images >= 16 else 0
    return max_photo_views


def grid_shape(h: int, w: int, cell_size: int):
    """(Cx, Cy) grid dimensions."""
    return (
        math.ceil((w - 1) / cell_size),
        math.ceil((h - 1) / cell_size),
    )


def make_occupancy(n_images: int, h: int, w: int, cell_size: int, device="cpu"):
    cx, cy = grid_shape(h, w, cell_size)
    return torch.zeros((n_images, cx, cy), dtype=torch.bool, device=device)


def which_cell(pix, cell_size: int):
    """Pixel (..., 2) float -> (..., 2) int32 cell (cx, cy)."""
    return torch.floor(pix / cell_size).to(torch.int32)


def cell_center(cell, cell_size: int):
    """Cell (..., 2) int -> pixel-space center."""
    return (cell.to(torch.float32) + 0.5) * cell_size


def is_vacant(occupancy, img_idx, cell):
    """Bounds-checked vacancy (out of bounds counts occupied)."""
    cx, cy = occupancy.shape[1], occupancy.shape[2]
    inb = (
        (cell[..., 0] >= 0)
        & (cell[..., 0] < cx)
        & (cell[..., 1] >= 0)
        & (cell[..., 1] < cy)
    )
    ci = torch.clamp(cell[..., 0], 0, cx - 1).long()
    cj = torch.clamp(cell[..., 1], 0, cy - 1).long()
    occupied = occupancy[img_idx.long(), ci, cj]
    return inb & ~occupied


def fill_cells(occupancy, img_idx, cells, mask):
    """Occupy cells; masked entries are dropped.  Returns a new grid.

    img_idx (...,) int32, cells (..., 2) int32, mask (...,) bool.  The JAX
    package scatters ``mask`` with a bool max (masked rows send False to
    cell 0, a no-op); bool has no scatter-max here, so every row writes
    True and masked rows write it to one spare slot past the grid, which
    is then dropped: order-free, deterministic, and no host sync (an
    ``index_fill_`` with the scalar; an indexed assignment of ``True``
    copies the scalar to the device and waits for it).
    """
    cx, cy = occupancy.shape[1], occupancy.shape[2]
    size = occupancy.numel()
    ci = torch.clamp(cells[..., 0], 0, cx - 1).long()
    cj = torch.clamp(cells[..., 1], 0, cy - 1).long()
    lin = (img_idx.long() * cx + ci) * cy + cj
    lin = torch.where(mask, lin, torch.full_like(lin, size))
    flat = torch.cat([occupancy.reshape(-1), occupancy.new_zeros(1)])
    flat.index_fill_(0, lin.reshape(-1), True)
    return flat[:size].reshape(occupancy.shape)


def _inbounds(x, y, h, w, wid):
    return (x >= wid + 1) & (x <= w - wid - 2) & (y >= wid + 1) & (y <= h - wid - 2)


def bilinear_sample_patches_stack(stack, img_idx, centers, wid: int = 5):
    """Sample (2*wid+1)^2 patches at fractional (x, y) centers with bilinear
    interpolation, each from its own image of an (N, H, W) stack.
    img_idx (...,) int; centers (..., 2) float.  The (side+1)^2 window is
    clipped inside the image (in-bounds mask: whole patch plus support).

    Returns (patches (..., side^2) float32, inbounds (...,) bool).
    """
    batch_shape = img_idx.shape
    n, h, w = stack.shape
    side = 2 * wid + 1
    ctr = centers.reshape(-1, 2)
    img = img_idx.reshape(-1).long().clamp(0, n - 1)
    x = ctr[:, 0]
    y = ctr[:, 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0).float()[:, None, None]
    fy = (y - y0).float()[:, None, None]
    # Fold (image, row) into one axis; windows never cross an image since
    # the row origin is clipped inside it.
    base_x = (x0.long() - wid).clamp(0, w - side - 1)
    base_y = (y0.long() - wid).clamp(0, h - side - 1) + img * h
    off = torch.arange(side + 1, device=stack.device)
    window = stack.reshape(n * h, w)[
        (base_y[:, None] + off)[:, :, None], (base_x[:, None] + off)[:, None, :]
    ]
    p00 = window[:, :side, :side]
    p01 = window[:, :side, 1:]
    p10 = window[:, 1:, :side]
    p11 = window[:, 1:, 1:]
    val = (
        p00 * (1 - fy) * (1 - fx)
        + p01 * (1 - fy) * fx
        + p10 * fy * (1 - fx)
        + p11 * fy * fx
    )
    return (
        val.reshape(*batch_shape, side * side).float(),
        _inbounds(x, y, h, w, wid).reshape(batch_shape),
    )



def _sample_plain(gray, img, ctr, wid, fp8=False):
    """Normalized bilinear patches on flat (M,) img / (M, 2) ctr: (M,
    side^2) bf16 (through float8 e4m3 with ``fp8``)."""
    patches, _ = bilinear_sample_patches_stack(gray.float(), img, ctr, wid)
    return descriptor_values(normalize_descriptors(patches),
                             fp8).to(torch.bfloat16)


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


def _sweep(gray, img, pix, wid: int, fp8: bool):
    """Normalized descriptors (..., D) bf16 and in-bounds (...,) of the
    samples ``img`` (...,) at ``pix`` (..., 2) in the bf16 stack."""
    img = img.to(torch.int32).contiguous()
    pix = pix.to(torch.float32).contiguous()
    h, w = gray.shape[1], gray.shape[2]
    desc = _sample_plain(gray, img.reshape(-1), pix.reshape(-1, 2), wid, fp8)
    inb = _inbounds(pix[..., 0], pix[..., 1], h, w, wid)
    return desc.reshape(*img.shape, -1), inb


def _ncc(desc, ref_desc, ncc_scale: float):
    """NCC of bf16 descriptors (M, V, D) against (M, D), in f32.

    ``torch.einsum`` on two bf16 tensors returns bf16, which would round
    every NCC before the 0.4/0.7 thresholds; the JAX package contracts bf16
    with an f32 result.  Products of bf16 values are exact in f32, so the
    operands are cast to f32 first (TF32 stays off, sfm_tpu_torch/__init__).
    """
    return torch.einsum("mvd,md->mv", desc.float(), ref_desc.float()) * ncc_scale


def photo_consistency(gray, K, R, t, centers, ref_idx, min_ncc,
                      wid: int = 5, max_views: int = 0, fp8: bool = False):
    """Score M candidate centres (M, 3) with reference images ``ref_idx``
    against all N views of the (N, H, W) stack; ``min_ncc`` a float or an
    (M,) tensor.  ``0 < max_views < N`` takes the geometric view gate.

    Returns (vis (M, N) bool, proj (M, N, 2) float32, score_mean (M,),
    vis_count (M,) int32)."""
    gray = gray.to(torch.bfloat16)
    h, w = gray.shape[1], gray.shape[2]
    samples = _view_samples(K, R, t, centers, ref_idx, h, w, wid, max_views)
    desc, inb = _sweep(gray, samples[1], samples[2], wid, fp8)
    if torch.is_tensor(min_ncc) and min_ncc.dim() == 1:
        min_ncc = min_ncc[:, None]
    return _score(desc, inb, samples, ref_idx, min_ncc, wid)


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


def build_seed_candidates(track_offsets, track_obs):
    """Host-side flattening of tracks into candidate pair arrays.

    Returns numpy arrays (track_id, ref_obs (C,3), other_obs (C,3)) — one
    candidate per non-reference observation of each track.
    """
    lengths = np.diff(track_offsets)
    n_tracks = len(lengths)
    ref_rows = track_obs[track_offsets[:-1]]          # (T, 3) first obs
    track_id = np.repeat(np.arange(n_tracks), lengths - 1)
    first_mask = np.zeros(track_obs.shape[0], bool)
    first_mask[track_offsets[:-1]] = True
    other_rows = track_obs[~first_mask]
    ref_per_cand = ref_rows[track_id]
    return track_id.astype(np.int32), ref_per_cand, other_rows


def _segment_min(values, segment_ids, n_segments: int, identity):
    """``jax.ops.segment_min``: empty segments hold ``identity`` (+inf for
    floats, INT32_MAX for int32).  A min is order-free, so the scatter is
    deterministic on every device."""
    out = torch.full((n_segments,), identity, dtype=values.dtype,
                     device=values.device)
    return out.scatter_reduce(0, segment_ids.long(), values, "amin",
                              include_self=True)


def seed_patches(
    gray,
    K, R, t, centers_cam,
    track_id, ref_obs, other_obs,
    n_tracks: int,
    occupancy,
    mc: dict,
    visible_lower_bound: int,
):
    """Batched seeding.

    Args (tensors on one device): gray (N,H,W) bf16; calibration (f32);
    candidate arrays from ``build_seed_candidates``; occupancy grid.

    Returns (dict of per-seed tensors (length n_tracks, masked by 'valid'),
    updated occupancy, packed (n_tracks, 11) float32 host payload per
    ``photoconsistency.pack_patch_payload``).
    """
    P = projection_matrix(K, R, t)
    ref_img = ref_obs[:, 0].long()
    oth_img = other_obs[:, 0].long()
    pix_ref = ref_obs[:, 1:3].to(torch.float32)
    pix_oth = other_obs[:, 1:3].to(torch.float32)

    # Pairwise two-view DLT per candidate.
    P_pair = torch.stack([P[ref_img], P[oth_img]], dim=1)   # (C, 2, 3, 4)
    pix_pair = torch.stack([pix_ref, pix_oth], dim=1)       # (C, 2, 2)
    c, w = triangulate_dlt(P_pair, pix_pair)
    c = refine_triangulation(P_pair, pix_pair, c)
    nondeg = w.abs() > 1e-12

    O = centers_cam[ref_img]                                # (C, 3)
    dvec = O - c
    dist = torch.sqrt(torch.sum(dvec * dvec, dim=-1))
    normal = dvec / torch.clamp_min(dist[:, None], 1e-12)

    vis, proj, score, cnt = photo_consistency(
        gray, K, R, t, c, ref_img, mc["min_ncc_seed"], mc["patch_wid"],
        resolve_photo_views(mc["max_photo_views"], gray.shape[0]),
        fp8=mc.get("fp8_descriptors", False),
    )
    passing = nondeg & (cnt >= visible_lower_bound)

    # Nearest-first, first-passing per track via two segment mins.
    key = torch.where(passing, dist, torch.full_like(dist, _BIG))
    seg_min = _segment_min(key, track_id, n_tracks, float("inf"))
    is_best = passing & (dist <= seg_min[track_id.long()])
    cand_idx = torch.arange(track_id.shape[0], dtype=torch.int32,
                            device=track_id.device)
    first = _segment_min(
        torch.where(is_best, cand_idx, torch.full_like(cand_idx, _INT32_MAX)),
        track_id, n_tracks, _INT32_MAX,
    )
    has_seed = first < _INT32_MAX
    sel = torch.clamp(first, 0, track_id.shape[0] - 1).long()

    seeds = {
        "c": c[sel],
        "n": normal[sel],
        "ref": ref_img[sel].to(torch.int32),
        "vis": vis[sel],
        "proj": proj[sel],
        "score": score[sel],
        "valid": has_seed,
    }
    # Occupy cells at every visible hit, plus the seed's own
    # reference-projection cell (so expansion cannot re-claim it).
    n_img = gray.shape[0]
    rows = torch.arange(n_tracks, device=sel.device)
    hit_cells = which_cell(seeds["proj"], mc["cell_size"])      # (T, N, 2)
    img_ids = torch.arange(n_img, dtype=torch.int32, device=sel.device)
    mask = seeds["vis"] & has_seed[:, None]
    occupancy = fill_cells(
        occupancy, img_ids[None, :].expand(n_tracks, n_img), hit_cells, mask
    )
    ref_long = seeds["ref"].long()
    occupancy = fill_cells(
        occupancy, seeds["ref"], hit_cells[rows, ref_long], has_seed
    )
    ref_pix = seeds["proj"][rows, ref_long]
    packed = pack_patch_payload(
        seeds["c"], seeds["n"], seeds["score"], ref_pix, seeds["ref"],
        has_seed,
    )
    return seeds, occupancy, packed


def ordered_compact(flags, size: int, fill: int):
    """``jnp.nonzero(flags, size=size, fill_value=fill)[0]`` as int64: the
    indices of the first ``size`` True flags, ascending, padded with
    ``fill``, with no host read (the JAX package's ``ordered_compact``).
    Each True flag's rank (a cumsum) is its slot; flags past ``size`` and
    False flags all go to one spare slot past the end, which is dropped.
    The pad repeats one index; if that candidate is valid its copies lose
    the cell claim to it (the claim key's ``- idx * 1e-7``)."""
    n = flags.shape[0]
    pos = torch.cumsum(flags, 0, dtype=torch.int64) - 1
    slot = torch.where(flags & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), fill, dtype=torch.int64, device=flags.device)
    out.scatter_(0, slot, torch.arange(n, dtype=torch.int64,
                                       device=flags.device))
    return out[:size]


def _diagonal_offsets(dev):
    """(4, 2) int32 [(-1, -1), (-1, 1), (1, -1), (1, 1)], made on ``dev``
    (no host-to-device copy)."""
    k = torch.arange(4, dtype=torch.int32, device=dev)
    return torch.stack([k // 2, k % 2], dim=1) * 2 - 1


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def expansion_round(gray, K, R, t, centers_cam, occupancy, f_c, f_n, f_vis,
                    f_proj, f_valid, mc: dict, visible_lower_bound: int,
                    round_capacity: int, scale: float):
    """One expansion round over the frontier.  Returns (the accepted dict
    of capacity ``round_capacity``, the next frontier, masked by 'valid';
    new occupancy; packed (C+1, 11) float32: rows 0..C-1 the patches, row
    C the round's counters)."""
    dev = f_c.device
    n_img = gray.shape[0]
    F = f_c.shape[0]

    # --- Candidate enumeration: visible hits per frontier row (row-wise
    # top-k over view weights that descend with the view index, so hits
    # come out patch-major, view-ascending), then the 4 diagonal offsets.
    photo_views = resolve_photo_views(mc["max_photo_views"], n_img)
    gated = 0 < photo_views < n_img
    k_hit = (photo_views - 1) if gated else n_img
    w_view = torch.arange(n_img, 0, -1, dtype=torch.int32, device=dev)
    hit_flags = f_valid[:, None] & f_vis
    wv, hit_img2 = _top_k(
        torch.where(hit_flags, w_view[None, :], torch.zeros_like(w_view)), k_hit
    )                                                          # (F, K)
    hit_cap = F * k_hit
    hit_valid = (wv > 0).reshape(-1)                           # (H,)
    # Visible hits beyond k_hit would be dropped: counted, never silent.
    hits_dropped = hit_flags.sum() - hit_valid.sum()
    hit_img = hit_img2.to(torch.int32).reshape(-1)             # (H,)
    hit_patch = torch.arange(F, device=dev)[:, None].expand(F, k_hit).reshape(-1)
    hit_pix = torch.gather(
        f_proj, 1, hit_img2[..., None].expand(F, k_hit, 2)
    ).reshape(-1, 2)                                           # (H, 2)
    hit_cell = which_cell(hit_pix, mc["cell_size"])           # (H, 2)
    cand_cell = hit_cell[:, None, :] + _diagonal_offsets(dev)[None]  # (H, 4, 2)
    img_ids = hit_img[:, None].expand(hit_cap, 4)
    vacant = is_vacant(occupancy, img_ids, cand_cell)
    cand_ok = hit_valid[:, None] & vacant

    # Pre-dedup before scoring: one proposer per (img, cell), the lowest
    # flat candidate index (scatter-min: order-free, deterministic).
    n_flat = hit_cap * 4
    cx, cy = occupancy.shape[1], occupancy.shape[2]
    cell_flat = cand_cell.reshape(-1, 2)
    img_flat = hit_img[:, None].expand(hit_cap, 4).reshape(-1).long()
    lin_all = (
        img_flat * cx + torch.clamp(cell_flat[:, 0], 0, cx - 1)
    ) * cy + torch.clamp(cell_flat[:, 1], 0, cy - 1)
    flat_ok = cand_ok.reshape(-1)
    idx_all = torch.arange(n_flat, dtype=torch.int32, device=dev)
    big = torch.full_like(idx_all, n_flat)
    first_at_cell = torch.full((occupancy.numel(),), n_flat, dtype=torch.int32,
                               device=dev)
    first_at_cell = first_at_cell.scatter_reduce(
        0, lin_all, torch.where(flat_ok, idx_all, big), "amin",
        include_self=True,
    )
    flat_ok = flat_ok & (first_at_cell[lin_all] == idx_all)

    sel = ordered_compact(flat_ok, round_capacity, n_flat - 1)
    sel_valid = flat_ok[sel]
    n_candidates = flat_ok.sum()

    parent = hit_patch[sel // 4]
    img = hit_img[sel // 4]
    img_l = img.long()
    cell = cell_flat[sel]

    # --- Geometry: back-project the cell centre, intersect the parent plane.
    center_pix = cell_center(cell, mc["cell_size"])
    O, ray = backproject_pixel(center_pix, K[img_l], R[img_l], t[img_l])
    c_new, ray_ok = ray_plane_intersection(O, ray, f_c[parent], f_n[parent])
    dvec = centers_cam[img_l] - c_new
    dist = _norm(dvec)
    n_new = dvec / torch.clamp_min(dist[:, None], 1e-12)

    # --- Photo-consistency for the whole batch.  A candidate whose ray is
    # parallel to its parent plane has a non-finite c_new and projections;
    # its samples are out of bounds (masked).
    vis, proj, score, cnt = photo_consistency(
        gray, K, R, t, c_new, img, mc["min_ncc_expand"],
        mc["patch_wid"], photo_views, fp8=mc.get("fp8_descriptors", False),
    )

    # --- Acceptance (reference rule). ---
    d = c_new - f_c[parent]
    coplanar = (
        torch.abs(
            torch.sum(d * f_n[parent], dim=-1) + torch.sum(d * n_new, dim=-1)
        )
        < mc["coplanarity_threshold"]
    )
    near = _norm(d) < mc["neighbor_radius_scaled"] / scale
    finite = torch.all(torch.isfinite(c_new), dim=-1)
    geom_ok = sel_valid & ray_ok & finite & coplanar & near
    accept = geom_ok & (cnt >= visible_lower_bound)

    # --- Intra-round dedup: one winner per target cell.  The claim key is
    # the f32 expression score - f32(idx) * f32(1e-7), idx an int32 arange,
    # as the JAX package computes it in f32: it decides which of two
    # near-equal patches wins a cell.
    lin = (
        img_l * cx + torch.clamp(cell[:, 0], 0, cx - 1)
    ) * cy + torch.clamp(cell[:, 1], 0, cy - 1)
    idx = torch.arange(round_capacity, dtype=torch.int32, device=dev)
    step = torch.full((), 1e-7, dtype=torch.float32, device=dev)
    claim_key = torch.where(
        accept, score - idx.to(torch.float32) * step,
        torch.full_like(score, -float("inf")),
    )
    best = torch.full((occupancy.numel(),), -float("inf"), dtype=claim_key.dtype,
                      device=dev)
    best = best.scatter_reduce(0, lin, claim_key, "amax", include_self=True)
    accept_pre_dedup = accept
    accept = accept & (claim_key >= best[lin]) & torch.isfinite(claim_key)

    # --- Occupancy: visible hits (at most k_hit per row, same top-k
    # extraction) + the target cell in the reference image.
    wa, fill_img = _top_k(
        torch.where(vis & accept[:, None], w_view[None, :],
                    torch.zeros_like(w_view)),
        k_hit,
    )                                                           # (C, K)
    fill_pix = torch.gather(proj, 1, fill_img[..., None].expand(*fill_img.shape, 2))
    occupancy = fill_cells(
        occupancy, fill_img, which_cell(fill_pix, mc["cell_size"]), wa > 0
    )
    occupancy = fill_cells(occupancy, img, cell, accept)

    accepted = {
        "c": c_new,
        "n": n_new,
        "ref": img,
        "vis": vis,
        "proj": proj,
        "score": score,
        "valid": accept,
    }
    rows = torch.arange(round_capacity, device=dev)
    ref_pix = proj[rows, img_l]
    packed = pack_patch_payload(c_new, n_new, score, ref_pix, img, accept)
    tail = torch.zeros((1, packed.shape[1]), dtype=torch.float32, device=dev)
    counts = torch.stack([
        n_candidates, hits_dropped, sel_valid.sum(),
        (sel_valid & ray_ok & finite).sum(), geom_ok.sum(),
        accept_pre_dedup.sum(), accept.sum(),
    ]).to(torch.float32)
    tail[0, :7] = counts
    return accepted, occupancy, torch.cat([packed, tail], dim=0)


def _pad_rows(v, rows: int):
    return torch.cat([v, v.new_zeros((rows - v.shape[0], *v.shape[1:]))])


def _split_frontier(fr, cap: int):
    """Fix the frontier's leading dim to ``cap``.  Valid patches beyond
    ``cap`` are not dropped: they go to a device-side backlog (valid-masked)
    that refills frontier slots in later rounds (_merge_backlog)."""
    fr = {k: fr[k] for k in _FRONTIER_KEYS}
    f = fr["c"].shape[0]
    if f <= cap:
        if f == cap:
            return fr, None
        return {k: _pad_rows(v, cap) for k, v in fr.items()}, None
    # Overflow: frontier = the first `cap` valid rows, backlog = the rest;
    # the backlog's capacity can only shrink from here.
    return _device_split_merge(fr, None, cap, f - cap)


def _merge_backlog(fr, backlog, cap: int):
    """FIFO refill: the next frontier is the OLDEST ``cap`` pending patches
    (backlog first, then this round's accepted patches in slot order);
    accepted patches that do not fit go to the backlog's tail.  Nothing is
    ever dropped."""
    if backlog is None:
        return fr, None
    return _device_split_merge(fr, backlog, cap, backlog["c"].shape[0])


def _device_split_merge(fr, backlog, cap: int, b_cap: int):
    """Compact the oldest ``cap`` valid rows of (backlog ++ frontier) into
    the next frontier; the remainder (masked) becomes the new backlog."""
    if backlog is not None:
        cat = {k: torch.cat([backlog[k], fr[k]]) for k in _FRONTIER_KEYS}
    else:
        cat = fr
    total = cat["valid"].shape[0]
    if total < cap + b_cap:
        cat = {k: _pad_rows(v, cap + b_cap) for k, v in cat.items()}
        total = cap + b_cap
    sel = ordered_compact(cat["valid"], total, total - 1)
    count = cat["valid"].sum()
    ok = torch.arange(total, device=sel.device) < count
    front = {k: cat[k][sel[:cap]] for k in _FRONTIER_KEYS}
    front["valid"] = front["valid"] & ok[:cap]
    if b_cap == 0:
        return front, None
    back = {k: cat[k][sel[cap: cap + b_cap]] for k in _FRONTIER_KEYS}
    back["valid"] = back["valid"] & ok[cap: cap + b_cap]
    return front, back




def dense_reconstruction(images, gray, K, R, t, centers, offsets, obs,
                         n_tracks: int, mc: dict, scale: float):
    """Seed patches from the tracks, then expand them round by round until
    a round accepts nothing with no patch deferred, or a budget runs out.

    ``images`` uint8 (N, H, W, 3) on the host (colours), ``gray`` the
    (N, H, W) float32 stack on the device, K, R, t, ``centers`` (camera
    centres) float32 there, ``offsets`` / ``obs`` the tracks.  Returns
    (points (D, 3) float32, normals (D, 3) float32, number of seeds)."""
    device = gray.device
    n, h, w = gray.shape
    bound = mc["visible_lower_bound"] if n > 2 else 1
    mc = dict(mc, max_photo_views=resolve_photo_views(mc["max_photo_views"], n))
    cap = mc["round_capacity"]
    gray = gray.to(torch.bfloat16)
    occupancy = make_occupancy(n, h, w, mc["cell_size"], device)

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    track_id, ref_obs, other_obs = build_seed_candidates(offsets, obs)
    seeds, occupancy, seed_packed = seed_patches(
        gray, K, R, t, centers, dev(track_id).to(torch.int32),
        dev(ref_obs).to(torch.int32), dev(other_obs).to(torch.int32),
        n_tracks, occupancy, mc, bound,
    )
    frontier, backlog = _split_frontier(seeds, cap)
    sp = seed_packed.cpu().numpy()
    seed_valid, s_c, s_n, _, _ = unpack_patch_payload(sp, images)
    n_seeds = int(seed_valid.sum())
    total, rounds = n_seeds, 0
    bl_count = max(0, n_seeds - cap) if backlog is not None else 0
    fr_valid = n_seeds - bl_count
    if backlog is not None and bl_count == 0:
        backlog = None
    all_c, all_n = [s_c[seed_valid]], [s_n[seed_valid]]
    first = True
    while rounds < mc["max_rounds"] and total < mc["max_patches"]:
        if bl_count and not first:
            frontier, backlog = _merge_backlog(frontier, backlog, cap)
            pending_rows = bl_count + fr_valid
            bl_count = max(0, pending_rows - cap)
            fr_valid = min(pending_rows, cap)
            if bl_count == 0:
                backlog = None
        first = False
        frontier, occupancy, packed = expansion_round(
            gray, K, R, t, centers, occupancy,
            frontier["c"], frontier["n"], frontier["vis"], frontier["proj"],
            frontier["valid"], mc, bound, cap, scale,
        )
        ph = packed.cpu().numpy()[:cap]
        acc_valid, a_c, a_n, _, _ = unpack_patch_payload(ph, images)
        n_acc = int(acc_valid.sum())
        fr_valid = n_acc
        rounds += 1
        if n_acc == 0:
            if bl_count == 0:
                break
            continue
        all_c.append(a_c[acc_valid])
        all_n.append(a_n[acc_valid])
        total += n_acc
    return (np.concatenate(all_c).astype(np.float32),
            np.concatenate(all_n).astype(np.float32), n_seeds)
