"""Dense reconstruction: seeding, then frontier expansion rounds.

Counterpart of ``sfm_tpu/mvs/pipeline.py``.  Work budget: ``max_patches``
accepted patches / ``max_rounds`` rounds; the host loop stops early when a
round accepts nothing and no deferred patch is left.  Each round's patches
reach the host as one small payload copy; the frontier, the backlog and
the occupancy grid stay on the device.

With a mesh (``parallel.DataMesh``) the stage runs on the mesh's lead
device, replicates the bf16 stack and the cameras once, seeds unsharded
(as the JAX package does) and splits every expansion round's candidate
batch over the shards (``mvs/expand.py``).

Not ported yet, and raising NotImplementedError: ``checkpoint_dir``
(mid-MVS resume, ROADMAP queue 1 item 12) and ``enable_outlier_filter``
(item 11).  ``MvsConfig.shape_buckets``,
``overlap_seed_fetch`` and ``rounds_per_call`` are scheduling knobs of the
JAX package (compile reuse, hiding a remote link's fetch latency) whose
output is identical either way; they are read nowhere here.
"""

from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from sfm_tpu_torch.config import (
    MvsConfig,
    RuntimeConfig,
    mvs_device_knobs,
    resolve_photo_views,
)
from sfm_tpu_torch.io.calib import Calibration
from sfm_tpu_torch.io.images import device_gray
from sfm_tpu_torch.mvs.cells import make_occupancy
from sfm_tpu_torch.mvs.expand import _nonzero_static, expansion_round
from sfm_tpu_torch.mvs.photoconsistency import unpack_patch_payload
from sfm_tpu_torch.mvs.seed import build_seed_candidates, seed_patches
from sfm_tpu_torch.ops._launch import use_kernel
from sfm_tpu_torch.parallel.mesh import DataMesh
from sfm_tpu_torch.sfm.pipeline import SparseReconstruction
from sfm_tpu_torch.utils.metrics import Metrics, StageTimer

# The expansion frontier consumes exactly these fields; seed dicts carry
# extras (ref, score) that must not leak into backlog bookkeeping.
_FRONTIER_KEYS = ("c", "n", "vis", "proj", "valid")


@dataclass
class DenseReconstruction:
    """Dense colored point cloud + per-patch geometry."""

    points: np.ndarray    # (D, 3) float32 patch centroids
    colors: np.ndarray    # (D, 3) uint8
    normals: np.ndarray   # (D, 3) float32
    scores: np.ndarray    # (D,) float32 mean NCC
    refs: np.ndarray      # (D,) int32 reference image per patch
    num_seeds: int
    metrics: Metrics = field(default_factory=Metrics)
    timers: Optional[StageTimer] = None

    @property
    def num_points(self) -> int:
        return self.points.shape[0]

    def export_ply(self, path: str) -> None:
        from sfm_tpu_torch.io.ply import export_ply

        export_ply(path, self.points, self.colors)


def _payload_refs(ph_rows, n_images: int) -> np.ndarray:
    """Reference-image index per patch from payload rows (column 9)."""
    return np.clip(ph_rows[:, 9].astype(np.int32), 0, n_images - 1)


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
    sel = _nonzero_static(cat["valid"], total, total - 1)
    count = cat["valid"].sum()
    ok = torch.arange(total, device=sel.device) < count
    front = {k: cat[k][sel[:cap]] for k in _FRONTIER_KEYS}
    front["valid"] = front["valid"] & ok[:cap]
    if b_cap == 0:
        return front, None
    back = {k: cat[k][sel[cap: cap + b_cap]] for k in _FRONTIER_KEYS}
    back["valid"] = back["valid"] & ok[cap: cap + b_cap]
    return front, back


def dense_reconstruction(
    images: np.ndarray,
    calib: Calibration,
    recon: SparseReconstruction,
    config: MvsConfig = MvsConfig(),
    scale: float = 1.0,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    device=RuntimeConfig.device,
    kernels=None,
) -> DenseReconstruction:
    """Run patch-based MVS from SfM tracks on ``device``.

    ``kernels`` as ``RuntimeConfig.kernels``: None runs kernel K2 on CUDA
    (its plain version on the CPU), False the plain version on any device.
    With ``mesh`` the stage runs on ``mesh.lead`` (``device`` is not read)
    and the expansion rounds shard their candidate batches; the cloud
    equals the unsharded run's.
    """
    if checkpoint_dir is not None:
        raise NotImplementedError(
            "MVS checkpoint/resume is not ported to sfm_tpu_torch yet "
            "(ROADMAP queue 1 item 12)"
        )
    if config.enable_outlier_filter:
        raise NotImplementedError(
            "the MVS outlier filter is not ported to sfm_tpu_torch yet "
            "(ROADMAP queue 1 item 11)"
        )
    timers = StageTimer()
    metrics = Metrics()
    n, h, w = images.shape[0], images.shape[1], images.shape[2]
    # The reference's 2-image carve-out (bound 2) is dead code, since the
    # visible set never counts the reference view; the intent is bound 1
    # (the same fix as sfm_tpu).
    bound = config.visible_lower_bound if n > 2 else 1
    config = dataclasses.replace(
        config, max_photo_views=resolve_photo_views(config.max_photo_views, n)
    )
    knobs = mvs_device_knobs(config)
    cap = config.round_capacity
    if mesh is not None:
        metrics.record("mvs_mesh_devices", mesh.size)
    device = mesh.lead if mesh is not None else torch.device(device)
    mesh = mesh or DataMesh([device])

    gray = device_gray(images, device)
    use_kernel(gray, kernels)  # kernels=True on a CPU device raises here
    # K2 reads a bf16 stack: one copy of the shared gray stack per stage.
    gray = gray.to(torch.bfloat16)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), device=device).to(dtype)

    K = dev(calib.K, torch.float32)
    R = dev(calib.R, torch.float32)
    t = dev(calib.t, torch.float32)
    centers_cam = dev(calib.centers, torch.float32)
    occupancy = make_occupancy(n, h, w, config.cell_size, device)
    # The expansion rounds' per-shard copies, made once for the stage.
    shards = tuple(mesh.replicate(x) for x in (gray, K, R, t))

    with timers.stage("seed"):
        track_id, ref_obs, other_obs = build_seed_candidates(
            recon.track_offsets, recon.track_obs
        )
        seeds, occupancy, seed_packed = seed_patches(
            gray, K, R, t, centers_cam,
            dev(track_id, torch.int32), dev(ref_obs, torch.int32),
            dev(other_obs, torch.int32),
            recon.num_tracks, occupancy, knobs, bound, kernels=kernels,
        )
        # ONE device->host copy for the whole seed stage; colors are
        # sampled on the host from the original images.
        sp = seed_packed.cpu().numpy()
        seed_valid, s_c, s_n, s_score, s_color = unpack_patch_payload(sp, images)
        n_seeds = int(seed_valid.sum())
        metrics.record("mvs_num_seeds", n_seeds)

    frontier, backlog = _split_frontier(seeds, cap)
    total = n_seeds
    # Exact live backlog count, tracked on the host with no device read:
    # the split kept the first `cap` valid rows, so n_seeds - cap were
    # deferred; each later merge updates it from the valid-row count of the
    # frontier folded back in (the JAX package's round-4 accounting).
    bl_count = max(0, n_seeds - cap) if backlog is not None else 0
    fr_valid = n_seeds - bl_count
    if backlog is not None and bl_count == 0:
        backlog = None
    if bl_count:
        metrics.record("mvs_seed_frontier_deferred", bl_count)
    all_c = [s_c[seed_valid]]
    all_n = [s_n[seed_valid]]
    all_score = [s_score[seed_valid]]
    all_color = [s_color[seed_valid]]
    all_ref = [_payload_refs(sp[seed_valid], n)]

    rounds = 0
    dropped_candidates = 0
    backlog_merge_s = 0.0
    backlog_rounds = 0
    hits_over_k = 0
    # Acceptance funnel, summed over rounds from the payload's tail row:
    # [scored, ray+finite, +coplanar+near, +NCC views, post-dedup accepts].
    funnel = np.zeros(5, np.int64)
    # A fresh split already holds the OLDEST `cap` valid seeds, so the
    # first round runs without a merge (FIFO order).
    skip_first_merge = True
    with timers.stage("expand"):
        while rounds < config.max_rounds and total < config.max_patches:
            if bl_count and not skip_first_merge:
                t0 = time.perf_counter()
                frontier, backlog = _merge_backlog(frontier, backlog, cap)
                backlog_merge_s += time.perf_counter() - t0
                backlog_rounds += 1
                # The merge folds bl_count backlog rows + fr_valid frontier
                # rows into the next frontier (capped at `cap`); the rest is
                # the new backlog.
                pending_rows = bl_count + fr_valid
                bl_count = max(0, pending_rows - cap)
                fr_valid = min(pending_rows, cap)
                if bl_count == 0:
                    backlog = None
            skip_first_merge = False
            frontier, occupancy, packed = expansion_round(
                *shards, centers_cam, occupancy,
                frontier["c"], frontier["n"], frontier["vis"],
                frontier["proj"], frontier["valid"],
                knobs, bound, cap, scale, kernels=kernels, mesh=mesh,
            )
            # ONE small copy per round; the frontier stays on the device.
            ph = packed.cpu().numpy()
            acc_valid, a_c, a_n, a_score, a_color = unpack_patch_payload(
                ph[:cap], images
            )
            n_acc = int(acc_valid.sum())
            fr_valid = n_acc
            dropped_candidates += max(0, int(ph[cap, 0]) - cap)
            hits_over_k += int(ph[cap, 1])
            funnel += ph[cap, 2:7].astype(np.int64)
            rounds += 1
            if n_acc == 0:
                # Frontier dry: deferred patches (if any) refill it at the
                # next merge, so stop only when the backlog is empty too.
                if bl_count == 0:
                    break
                continue
            all_c.append(a_c[acc_valid])
            all_n.append(a_n[acc_valid])
            all_score.append(a_score[acc_valid])
            all_color.append(a_color[acc_valid])
            all_ref.append(_payload_refs(ph[:cap][acc_valid], n))
            total += n_acc
    metrics.record("mvs_rounds", rounds)
    metrics.record("mvs_num_points", total)
    if funnel[0]:
        metrics.record("mvs_candidates_scored", int(funnel[0]))
        metrics.record("mvs_pass_ray_finite", int(funnel[1]))
        metrics.record("mvs_pass_geometry", int(funnel[2]))
        metrics.record("mvs_pass_ncc", int(funnel[3]))
        metrics.record("mvs_accepted", int(funnel[4]))
        metrics.record(
            "mvs_accept_rate", round(float(funnel[4]) / float(funnel[0]), 4)
        )
    if backlog_rounds:
        metrics.record("mvs_backlog_rounds", backlog_rounds)
        metrics.record("mvs_backlog_merge_s", round(backlog_merge_s, 4))
    if bl_count:
        # Deferred patches still unexpanded when a budget ran out.
        metrics.record("mvs_backlog_remaining", bl_count)
    metrics.record("mvs_candidates_over_capacity", dropped_candidates)
    if hits_over_k:
        metrics.record("mvs_hits_over_k", hits_over_k)

    return DenseReconstruction(
        points=np.concatenate(all_c).astype(np.float32),
        colors=np.concatenate(all_color).astype(np.uint8),
        normals=np.concatenate(all_n).astype(np.float32),
        scores=np.concatenate(all_score).astype(np.float32),
        refs=np.concatenate(all_ref).astype(np.int32),
        num_seeds=n_seeds,
        metrics=metrics,
        timers=timers,
    )
