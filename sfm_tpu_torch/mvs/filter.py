"""Visibility-consistency outlier filtering.

Counterpart of ``sfm_tpu/mvs/filter.py``: PMVS's outlier filter with the
reference's exact pairwise rule.  Per cell, a patch p2 is an outlier if ANY
other patch p1 sharing the cell is non-neighbouring with it
(|d.n1 + d.n2| >= 0.2) AND p2's support (visible_count * avg_ncc) falls
below the cell's mean (1 - avg_ncc).  The rule applies to every cell a
patch hits.

``filter_outliers`` is the host oracle (numpy): incidences grouped by cell,
each group padded to the largest, the pairwise test as a batched
(cells, G, G) computation.  ``filter_outliers_device`` gives the identical
keep-mask with torch ops on the patches' device: incidences sorted by cell
key, each compared with its next ``g_cap - 1`` sorted neighbours.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.mvs.photoconsistency import _top_k


def filter_outliers(
    points: np.ndarray,     # (D, 3)
    normals: np.ndarray,    # (D, 3)
    scores: np.ndarray,     # (D,) mean NCC
    vis: np.ndarray,        # (D, N) bool visible-view mask
    proj: np.ndarray,       # (D, N, 2) projected pixels
    cell_size: int,
    grid_w: int,
    grid_h: int,
    neighbor_threshold: float = 0.2,
    cell_chunk: int = 8192,
) -> np.ndarray:
    """Return a keep-mask (D,) bool (host oracle)."""
    d, n = vis.shape
    if d == 0:
        return np.ones(0, bool)
    vis_ct = vis.sum(1)

    # (patch, cell) incidence from visible hits.
    pid, img = np.nonzero(vis)
    px = np.clip((proj[pid, img, 0] // cell_size).astype(np.int64), 0, grid_w - 1)
    py = np.clip((proj[pid, img, 1] // cell_size).astype(np.int64), 0, grid_h - 1)
    cell = (img.astype(np.int64) * grid_w + px) * grid_h + py

    # Group incidences by cell.
    order = np.argsort(cell, kind="stable")
    pid_s = pid[order]
    cell_s = cell[order]
    uniq, starts, cnt = np.unique(cell_s, return_index=True, return_counts=True)
    n_cells = len(uniq)

    # Per-cell support threshold: mean(1 - score) over the cell's patches
    # (the candidate itself included).
    inv = np.repeat(np.arange(n_cells), cnt)
    thr = np.bincount(inv, weights=(1.0 - scores[pid_s])) / cnt

    multi = cnt > 1
    if not multi.any():
        return np.ones(d, bool)

    removed = np.zeros(d, bool)
    G = int(cnt[multi].max())
    mcells = np.flatnonzero(multi)
    for lo in range(0, len(mcells), cell_chunk):
        sel = mcells[lo: lo + cell_chunk]
        c = len(sel)
        # Padded (c, G) patch-id table for this chunk of cells.
        tbl = np.zeros((c, G), np.int64)
        valid = np.arange(G)[None, :] < cnt[sel][:, None]
        flat_rows = np.repeat(np.arange(c), cnt[sel])
        flat_cols = np.concatenate([np.arange(k) for k in cnt[sel]])
        src = np.concatenate(
            [pid_s[starts[i]: starts[i] + cnt[i]] for i in sel]
        )
        tbl[flat_rows, flat_cols] = src
        # Exact pairwise planarity |d.n_a + d.n_b| per cell (c, G, G), with
        # d = p_a - p_b.
        P = points[tbl]                       # (c, G, 3)
        Nrm = normals[tbl]
        dvec = P[:, :, None, :] - P[:, None, :, :]
        plan = np.abs(
            np.einsum("cabj,caj->cab", dvec, Nrm)
            + np.einsum("cabj,cbj->cab", dvec, Nrm)
        )
        pair_ok = valid[:, :, None] & valid[:, None, :]
        diff = tbl[:, :, None] != tbl[:, None, :]
        # Patch in column b is non-neighbouring with SOME other patch a.
        non_nb_any = (
            (plan >= neighbor_threshold) & pair_ok & diff
        ).any(axis=1)                          # (c, G) over b
        weak = vis_ct[tbl] * scores[tbl] < thr[sel][:, None]
        flagged = non_nb_any & weak & valid
        removed[tbl[flagged]] = True
    return ~removed


def filter_outliers_device(
    points,      # (D, 3) f32
    normals,     # (D, 3) f32
    scores,      # (D,) f32
    vis,         # (D, N) bool
    proj,        # (D, N, 2) f32
    valid,       # (D,) bool: padding mask (pad rows contribute nothing)
    cell_size: int,
    grid_w: int,
    grid_h: int,
    neighbor_threshold: float = 0.2,
    g_cap: int = 64,
    k_hit: int = 0,
):
    """Device version of :func:`filter_outliers`: the identical keep-mask.

    Incidences (patch, cell) are sorted by cell key, stably, and each sorted
    entry is compared with its next ``g_cap - 1`` neighbours (same key =>
    same cell), so every unordered pair of cellmates is visited once, with
    no data-dependent shapes.  The same passes sum each cell's
    (1 - score) for the support threshold, per incidence and in a fixed
    order (by offset, in float64, as the oracle's ``bincount`` sums): a
    float ``index_add_`` into a cell grid would sum in another order on
    every run of a CUDA device, and the threshold feeds a comparison.  The
    per-cell counts are an integer scatter-add, which has one result in any
    order.

    ``g_cap`` must exceed the largest cell occupancy for exactness; the
    returned ``max_group`` lets the caller verify and run again with a
    larger cap.  ``k_hit`` (0 = N) bounds the visible views per patch: a
    view-gated pipeline passes ``max_photo_views - 1``, which shrinks the
    incidence space N / k_hit-fold; a row with more hits than ``k_hit``
    shows in ``hits_dropped`` (exactness violated; the caller raises).

    Returns (keep (D,) bool, padding rows False; max_group 0-dim int64;
    hits_dropped 0-dim int64), all on the inputs' device.
    """
    d, n = vis.shape
    dev = vis.device
    vis = vis & valid[:, None]
    vis_ct = vis.sum(dim=1)                                     # (D,)
    k_hit = n if k_hit <= 0 else min(k_hit, n)
    # Compact each row's hits to its first k_hit visible views (order within
    # a cell does not matter: the pairwise rule is symmetric).
    wv_desc = torch.arange(n, 0, -1, dtype=torch.int32, device=dev)
    wv, hit_img = _top_k(
        torch.where(vis, wv_desc[None, :], torch.zeros_like(wv_desc)[None, :]),
        k_hit,
    )                                                           # (D, K)
    inc_ok = (wv > 0).reshape(-1)                               # (I,)
    img_f = hit_img.reshape(-1)
    pid_f = torch.arange(d, device=dev).repeat_interleave(k_hit)
    pix = torch.gather(
        proj, 1, hit_img[..., None].expand(d, k_hit, 2)
    ).reshape(-1, 2)                                            # (I, 2)
    cell = torch.div(pix, cell_size, rounding_mode="floor").long()
    px = cell[:, 0].clamp(0, grid_w - 1)
    py = cell[:, 1].clamp(0, grid_h - 1)
    lin_f = (img_f * grid_w + px) * grid_h + py                 # (I,)

    n_cells = n * grid_w * grid_h
    cnt = torch.zeros(n_cells, dtype=torch.int64, device=dev).index_add_(
        0, lin_f, inc_ok.long()
    )
    max_group = cnt.max() if d else cnt.new_zeros(())

    # Sort incidences by cell key (invalid -> a sentinel past every real key).
    key = torch.where(inc_ok, lin_f, torch.full_like(lin_f, n_cells))
    order = torch.argsort(key, stable=True)
    key_s = key[order]
    pid_s = pid_f[order]
    p_s = points[pid_s]
    n_s = normals[pid_s]
    # (1 - score) in the scores' type, summed in float64, as the oracle does.
    val_s = (1.0 - scores[pid_s]).double() * inc_ok[order]
    size = key.shape[0]
    pos = torch.arange(size, device=dev)

    ssum = val_s.clone()
    non_nb_any = torch.zeros(size, dtype=torch.bool, device=dev)
    for off in range(1, min(g_cap, max(size, 1))):
        # Sorted entry i against entry i + off: a real pair iff both share a
        # cell key and the window did not wrap.
        same = (key_s == torch.roll(key_s, -off)) & (key_s < n_cells) & (
            pos < size - off
        )
        dvec = p_s - torch.roll(p_s, -off, 0)
        plan = torch.abs(
            torch.sum(dvec * n_s, dim=-1)
            + torch.sum(dvec * torch.roll(n_s, -off, 0), dim=-1)
        )
        non_nb = same & (plan >= neighbor_threshold)
        non_nb_any |= non_nb | torch.roll(non_nb, off)
        zero = torch.zeros_like(val_s)
        ssum = ssum + torch.where(same, torch.roll(val_s, -off), zero)
        ssum = ssum + torch.roll(torch.where(same, val_s, zero), off)
    thr_s = ssum / cnt[key_s.clamp(max=n_cells - 1)].clamp(min=1)
    weak_s = (key_s < n_cells) & (
        vis_ct[pid_s].double() * scores[pid_s].double() < thr_s
    )
    removed = torch.zeros(d, dtype=torch.bool, device=dev)
    removed[pid_s[non_nb_any & weak_s]] = True
    hits_dropped = vis.sum() - inc_ok.sum()
    return ~removed & valid, max_group, hits_dropped
