"""MVS seeding from SfM tracks.

Counterpart of ``sfm_tpu/mvs/seed.py``: every track contributes one
candidate per non-reference observation (its first observation fixes the
reference image and pixel), pairwise-triangulated against the reference;
all candidates of all tracks are photo-consistency scored in one batch;
per track, the passing candidate nearest the reference camera wins (the
reference's pop-nearest-first, take-first-passing order, as two segment
minima).
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.config import MvsConfig, resolve_photo_views
from sfm_tpu_torch.geometry.projection import projection_matrix
from sfm_tpu_torch.geometry.triangulation import (
    refine_triangulation,
    triangulate_dlt,
)
from sfm_tpu_torch.mvs.cells import fill_cells, which_cell
from sfm_tpu_torch.mvs.photoconsistency import (
    pack_patch_payload,
    photo_consistency,
)

_BIG = 1e30  # f32(1e30), the "no passing candidate" distance key
_INT32_MAX = int(np.iinfo(np.int32).max)


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
    config: MvsConfig,
    visible_lower_bound: int,
    kernels=None,
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
        gray, K, R, t, c, ref_img, config.min_ncc_seed, config.patch_wid,
        resolve_photo_views(config.max_photo_views, gray.shape[0]),
        kernels=kernels,
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
    hit_cells = which_cell(seeds["proj"], config.cell_size)      # (T, N, 2)
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
