"""Frontier-round patch expansion.

Counterpart of ``sfm_tpu/mvs/expand.py``.  Each round takes the whole
frontier (patches accepted last round), enumerates every (visible hit,
diagonal neighbour) candidate cell at once, keeps one proposer per vacant
cell, back-projects the cell centres onto the parent patch planes, scores
the batch with one photo-consistency sweep (kernel K2 on CUDA), applies
the reference's acceptance rules (>= bound views, coplanarity < 0.1,
radius < 0.05/scale), keeps one winner per target cell, and occupies the
cells.  The same deliberate fixes over the reference as the JAX package:
(i, j) neighbour cells, each view projected with its own camera, and an
accepted patch also occupies its target cell in its reference image.

The JAX package's ``rounds_per_call`` chunking (several rounds in one
device program, to amortise a remote link's fetch) and its mesh sharding
hooks have no counterpart: this is one round per call, the chunked output
being identical.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.config import MvsConfig, resolve_photo_views
from sfm_tpu_torch.geometry.triangulation import (
    backproject_pixel,
    ray_plane_intersection,
)
from sfm_tpu_torch.mvs.cells import (
    cell_center,
    fill_cells,
    is_vacant,
    which_cell,
)
from sfm_tpu_torch.mvs.photoconsistency import (
    _top_k,
    pack_patch_payload,
    photo_consistency,
)

_OFFSETS = ((-1, -1), (-1, 1), (1, -1), (1, 1))


def _nonzero_static(flags, size: int, fill: int):
    """``jnp.nonzero(flags, size=size, fill_value=fill)[0]``: the indices of
    the first ``size`` True flags, ascending, padded with ``fill``.  The
    pad repeats one index; if that candidate is valid its copies lose the
    cell claim to it (the claim key's ``- idx * 1e-7``).  One host sync."""
    idx = torch.nonzero(flags).reshape(-1)[:size]
    pad = torch.full((size - idx.shape[0],), fill, dtype=idx.dtype,
                     device=idx.device)
    return torch.cat([idx, pad])


def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1))


def expansion_round(
    gray,
    K, R, t, centers_cam,
    occupancy,
    f_c, f_n, f_vis, f_proj, f_valid,
    config: MvsConfig,
    visible_lower_bound: int,
    round_capacity: int,
    scale: float,
    kernels=None,
):
    """One expansion round over the frontier.

    Frontier tensors: f_c (F,3), f_n (F,3), f_vis (F,N), f_proj (F,N,2),
    f_valid (F,); gray (N,H,W) bf16.  Returns (accepted dict of capacity
    ``round_capacity`` — the next frontier, masked by 'valid' —, new
    occupancy, packed (C+1, 11) float32: rows 0..C-1 per
    ``photoconsistency.pack_patch_payload``, row C the round's counters
    [n_candidates, hits_dropped, scored, ray+finite, +geometry, +NCC
    views, accepted]).
    """
    dev = f_c.device
    n_img = gray.shape[0]
    F = f_c.shape[0]

    # --- Candidate enumeration: visible hits per frontier row (row-wise
    # top-k over view weights that descend with the view index, so hits
    # come out patch-major, view-ascending), then the 4 diagonal offsets.
    photo_views = resolve_photo_views(config.max_photo_views, n_img)
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
    hit_patch = torch.arange(F, device=dev).repeat_interleave(k_hit)
    hit_pix = torch.gather(
        f_proj, 1, hit_img2[..., None].expand(F, k_hit, 2)
    ).reshape(-1, 2)                                           # (H, 2)
    hit_cell = which_cell(hit_pix, config.cell_size)           # (H, 2)
    offsets = torch.tensor(_OFFSETS, dtype=torch.int32, device=dev)
    cand_cell = hit_cell[:, None, :] + offsets[None]           # (H, 4, 2)
    img_ids = hit_img[:, None].expand(hit_cap, 4)
    vacant = is_vacant(occupancy, img_ids, cand_cell)
    cand_ok = hit_valid[:, None] & vacant

    # Pre-dedup before scoring: one proposer per (img, cell), the lowest
    # flat candidate index (scatter-min: order-free, deterministic).
    n_flat = hit_cap * 4
    cx, cy = occupancy.shape[1], occupancy.shape[2]
    cell_flat = cand_cell.reshape(-1, 2)
    img_flat = hit_img.repeat_interleave(4).long()
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

    sel = _nonzero_static(flat_ok, round_capacity, n_flat - 1)
    sel_valid = flat_ok[sel]
    n_candidates = flat_ok.sum()

    parent = hit_patch[sel // 4]
    img = hit_img[sel // 4]
    img_l = img.long()
    cell = cell_flat[sel]

    # --- Geometry: back-project the cell centre, intersect the parent plane.
    center_pix = cell_center(cell, config.cell_size)
    O, ray = backproject_pixel(center_pix, K[img_l], R[img_l], t[img_l])
    c_new, ray_ok = ray_plane_intersection(O, ray, f_c[parent], f_n[parent])
    dvec = centers_cam[img_l] - c_new
    dist = _norm(dvec)
    n_new = dvec / torch.clamp_min(dist[:, None], 1e-12)

    # --- Photo-consistency for the whole batch (K2 on CUDA).  A candidate
    # whose ray is parallel to its parent plane has a non-finite c_new and
    # projections; its samples are out of bounds (masked), and K2 clamps
    # the window origin in float, so the read stays inside the stack.
    vis, proj, score, cnt = photo_consistency(
        gray, K, R, t, c_new, img, config.min_ncc_expand, config.patch_wid,
        photo_views, kernels=kernels,
    )

    # --- Acceptance (reference rule). ---
    d = c_new - f_c[parent]
    coplanar = (
        torch.abs(
            torch.sum(d * f_n[parent], dim=-1) + torch.sum(d * n_new, dim=-1)
        )
        < config.coplanarity_threshold
    )
    near = _norm(d) < config.neighbor_radius_scaled / scale
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
    step = torch.tensor(1e-7, dtype=torch.float32, device=dev)
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
        occupancy, fill_img, which_cell(fill_pix, config.cell_size), wa > 0
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
