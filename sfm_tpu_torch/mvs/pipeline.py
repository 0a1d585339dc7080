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

With ``checkpoint_dir`` the expansion loop saves its whole state every
``checkpoint_every`` rounds and resumes from it on the next call
(``utils/checkpoint.py``: the JAX package's file and array names, its v2
fingerprint letter for letter); the resumed run's cloud is bit-identical to
an uninterrupted one.  With ``MvsConfig.enable_outlier_filter`` the
accumulated cloud is re-scored in one sweep (K2's largest launch) and
filtered on the device (``mvs/filter.py``).

The host loop is the JAX package's, letter for letter.  A round issues
no host read (``mvs/expand.py``), and each chunk's payload is copied to
pinned host memory as soon as the chunk is enqueued, with an event behind
it: the host enqueues the next chunk first and then waits on this one's
event, so the device runs ahead of the host's unpacking (dispatch-ahead,
only where the next chunk is certainly the one the serial loop would run:
no backlog merge pending, neither budget reachable, no checkpoint due).
``MvsConfig.rounds_per_call`` rounds go in one chunk, with the backlog
merged only between chunks, so with a backlog it changes the cloud, as it
does in ``sfm_tpu``.  ``overlap_seed_fetch`` enqueues round 1 before the
seed payload is read.  A chunk enqueued ahead of one that ends the stage
runs and is never read.  ``shape_buckets`` pads
nothing the stage computes on: it only sets the width of the image axis in
the state file, which ``sfm_tpu`` pads to ``bucket_images(n)`` when it is
on (``_to_state_width``, ``_from_state_width``).
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
from sfm_tpu_torch.io.images import _cache_key, device_gray
from sfm_tpu_torch.mvs.cells import grid_shape, make_occupancy
from sfm_tpu_torch.mvs.expand import expansion_round, ordered_compact
from sfm_tpu_torch.mvs.filter import filter_outliers_device
from sfm_tpu_torch.mvs.photoconsistency import (
    photo_consistency,
    unpack_patch_payload,
)
from sfm_tpu_torch.mvs.seed import build_seed_candidates, seed_patches
from sfm_tpu_torch.ops._launch import use_kernel
from sfm_tpu_torch.parallel.mesh import DataMesh
from sfm_tpu_torch.sfm.pipeline import SparseReconstruction
from sfm_tpu_torch.utils import checkpoint as ckpt
from sfm_tpu_torch.utils.buckets import bucket_images
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


class _HostCopy:
    """A payload's copy to the host, enqueued when this is made (on the
    current stream of the tensor's device, into pinned memory, with an
    event behind it) and waited for only in ``numpy()``.  A CPU tensor is
    its own copy."""

    def __init__(self, t: torch.Tensor):
        self.event = None
        if not t.is_cuda:
            self.host = t
            return
        self.host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        self.host.copy_(t, non_blocking=True)
        self.event = torch.cuda.Event()
        self.event.record(torch.cuda.current_stream(t.device))

    def numpy(self) -> np.ndarray:
        if self.event is not None:
            self.event.synchronize()
        return self.host.numpy()


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


_FILTER_G_CAP = 64  # the filter's first neighbour window; escalates


def _run_device_filter(
    mesh, gray, K, R, t, points, normals, scores, refs, n_seeds,
    h, w, config: MvsConfig, metrics, kernels=None,
):
    """Host side of the device outlier filter; returns keep (D,) bool.

    The visibility of the whole accumulated cloud is recomputed in one
    ``photo_consistency`` sweep (split over ``mesh``'s shards; ``gray``,
    K, R, t are the per-shard replicas), each patch at its own accept-time
    threshold: seeds were scored at ``min_ncc_seed``, expansion patches at
    ``min_ncc_expand``.  ``g_cap`` starts at ``_FILTER_G_CAP`` and escalates when a cell
    holds more patches (counted, never silently inexact).  keep, the
    largest cell group and the dropped-hit count reach the host in one
    copy.
    """
    d = points.shape[0]
    if d == 0:
        return np.ones(0, bool)
    dev = mesh.lead
    n_img = gray[0].shape[0]
    gw, gh = grid_shape(h, w, config.cell_size)
    pv = resolve_photo_views(config.max_photo_views, n_img)
    pts, nrm, sco = (torch.from_numpy(a).to(dev) for a in (points, normals, scores))
    thr = torch.from_numpy(np.where(
        np.arange(d) < n_seeds, config.min_ncc_seed, config.min_ncc_expand,
    ).astype(np.float32)).to(dev)
    vis, proj, _, _ = photo_consistency(
        gray, K, R, t, pts, torch.from_numpy(refs).to(dev), thr,
        config.patch_wid, pv, kernels=kernels, mesh=mesh,
    )
    # The view gate bounds the visible views per patch, so the filter's
    # incidence space compacts to photo_views - 1 per row.
    k_hit = pv - 1 if 0 < pv < n_img else 0
    valid = torch.ones(d, dtype=torch.bool, device=dev)
    g_cap = _FILTER_G_CAP
    while True:
        keep, max_group, hits_dropped = filter_outliers_device(
            pts, nrm, sco, vis, proj, valid, config.cell_size, gw, gh,
            g_cap=g_cap, k_hit=k_hit,
        )
        out = torch.cat(
            [keep.long(), max_group[None], hits_dropped[None]]
        ).cpu().numpy()
        max_group, hits_dropped = int(out[d]), int(out[d + 1])
        if hits_dropped:
            # A vis row exceeded the gate's per-row bound: cannot happen
            # for visibility the same gate produced, and the keep mask
            # would be inexact.
            metrics.record("mvs_filter_hits_over_k", hits_dropped)
            raise RuntimeError(
                f"outlier filter: {hits_dropped} visible hits beyond the "
                f"view gate's {k_hit} per patch; the keep mask would be "
                "inexact"
            )
        if max_group <= g_cap:
            break
        # Exactness needs shifted-window offsets up to max_group - 1.
        metrics.record("mvs_filter_gcap_escalated", max_group)
        g_cap = 1 << (max_group - 1).bit_length()
    metrics.record("mvs_filter_max_cell_group", max_group)
    return out[:d] > 0


def _mvs_fingerprint(images, config, bound, scale) -> str:
    """Configuration fingerprint guarding mid-MVS checkpoint resumes: the
    JAX package's v2 string, letter for letter, without its ``|nb{n}``
    suffix (the state file's image-axis width, which the caller appends);
    its ``crc`` is the last field of ``io.images._cache_key``.

    Budget knobs (max_rounds, max_patches) are deliberately excluded: a
    legitimate resume may raise them to continue a finished budget.  Shape,
    threshold and input knobs must match, or the restored occupancy and
    frontier would not fit the run.
    """
    n, h, w = images.shape[:3]
    return (
        f"v2|{n}x{h}x{w}|crc{_cache_key(images)[-1]}|cell{config.cell_size}"
        f"|wid{config.patch_wid}|ncc{config.min_ncc_seed}/{config.min_ncc_expand}"
        f"|bound{bound}|cap{config.round_capacity}"
        f"|views{resolve_photo_views(config.max_photo_views, n)}"
        f"|cop{config.coplanarity_threshold}|rad{config.neighbor_radius_scaled}"
        f"|scale{scale}|filter{int(config.enable_outlier_filter)}"
    )


# State arrays with an image axis, and where it is: occupancy (N, Cx, Cy);
# frontier / backlog vis (F, N) and proj (F, N, 2).
_IMAGE_AXIS = {"occupancy": 0, "f_vis": 1, "f_proj": 1, "b_vis": 1, "b_proj": 1}


def _to_state_width(state: dict, n_state: int) -> dict:
    """Pad the image axis of the state arrays to ``n_state`` (the JAX
    package's bucketed width) with inert views: never occupied, never
    visible, projected at (0, 0)."""
    out = dict(state)
    for k, axis in _IMAGE_AXIS.items():
        if k in out:
            a = out[k]
            pad = [(0, 0)] * a.ndim
            pad[axis] = (0, n_state - a.shape[axis])
            out[k] = np.pad(a, pad)
    return out


def _from_state_width(state: dict, n: int) -> dict:
    """Slice the image axis of the state arrays back to the ``n`` real
    views; raises if a pad view was occupied or visible (a state that does
    not come from an inert padding)."""
    out = dict(state)
    for k, axis in _IMAGE_AXIS.items():
        if k not in out or out[k].shape[axis] == n:
            continue
        a = out[k]
        if not k.endswith("proj") and np.take(a, range(n, a.shape[axis]),
                                              axis=axis).any():
            raise ValueError(
                f"MVS checkpoint: {k} marks a padded view beyond the {n} "
                "real images; the state is not from this input"
            )
        out[k] = np.take(a, range(n), axis=axis)
    return out


def dense_reconstruction(
    images: np.ndarray,
    calib: Calibration,
    recon: SparseReconstruction,
    config: MvsConfig = MvsConfig(),
    scale: float = 1.0,
    mesh=None,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 16,
    device=RuntimeConfig.device,
    kernels=None,
) -> DenseReconstruction:
    """Run patch-based MVS from SfM tracks on ``device``.

    ``kernels`` as ``RuntimeConfig.kernels``: None runs kernel K2 on CUDA
    (its plain version on the CPU), False the plain version on any device.
    With ``mesh`` the stage runs on ``mesh.lead`` (``device`` is not read)
    and the expansion rounds shard their candidate batches; the cloud
    equals the unsharded run's.

    With ``checkpoint_dir`` the expansion loop persists its full state
    (occupancy, frontier, backlog, accumulated cloud, counters) every
    ``checkpoint_every`` rounds and resumes from it on the next call; the
    state tensors go to numpy on save and back to the stage's device on
    load.  The stage is deterministic, so the resumed cloud is the
    uninterrupted run's, bit for bit.  Over a group mesh only process 0
    writes (and clears) the state file, and every process reads it.
    """
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

    def dev(a, dtype=None):
        x = torch.as_tensor(np.ascontiguousarray(a), device=device)
        return x if dtype is None else x.to(dtype)

    K = dev(calib.K, torch.float32)
    R = dev(calib.R, torch.float32)
    t = dev(calib.t, torch.float32)
    centers_cam = dev(calib.centers, torch.float32)
    occupancy = make_occupancy(n, h, w, config.cell_size, device)
    # The expansion rounds' per-shard copies, made once for the stage.
    shards = tuple(mesh.replicate(x) for x in (gray, K, R, t))

    # The state file's image axis: sfm_tpu's bucketed width when shape
    # buckets are on (its default), else the real count; either is read.
    n_state = bucket_images(n) if config.shape_buckets else n
    base_fp = (
        _mvs_fingerprint(images, config, bound, scale) if checkpoint_dir else ""
    )
    fingerprint = f"{base_fp}|nb{n_state}"
    state = ckpt.load_mvs_state(checkpoint_dir)
    resumed = state is not None
    if resumed:
        saved_fp = str(state["fingerprint"])
        if saved_fp not in {f"{base_fp}|nb{m}" for m in (n, bucket_images(n))}:
            raise ValueError(
                f"MVS checkpoint in {checkpoint_dir} was written with a "
                f"different configuration/input ({saved_fp!r} != "
                f"{fingerprint!r}); delete {ckpt.MVS_STATE_FILE} to restart"
            )
        state = _from_state_width(state, n)
        occupancy = dev(state["occupancy"])
        frontier = {k: dev(state["f_" + k]) for k in _FRONTIER_KEYS}
        # Valid rows in the restored (not yet dispatched) frontier: the
        # backlog-merge accounting needs it.
        fr_valid = int(state["f_valid"].sum())
        backlog, bl_count = None, 0
        if "b_c" in state:
            bl_count = int(state["b_valid"].sum())
            if bl_count:
                backlog = {k: dev(state["b_" + k]) for k in _FRONTIER_KEYS}
        total, rounds, dropped_candidates, n_seeds = (
            int(x) for x in state["counters"]
        )
        all_c = [state["acc_c"]]
        all_n = [state["acc_n"]]
        all_score = [state["acc_score"]]
        all_color = [state["acc_color"]]
        all_ref = [state["acc_ref"]]
        metrics.record("mvs_num_seeds", n_seeds)
        metrics.record("mvs_resumed_at_round", rounds)
    # config.rounds_per_call rounds go in one chunk: enqueued back to back
    # with no host read and no backlog merge between them (mvs/expand.py).
    chunk = max(config.rounds_per_call, 1)

    def dispatch():
        """Enqueue the next chunk and its payload's copy to the host."""
        nonlocal frontier, occupancy
        frontier, occupancy, packed = expansion_round(
            *shards, centers_cam, occupancy,
            frontier["c"], frontier["n"], frontier["vis"],
            frontier["proj"], frontier["valid"],
            knobs, bound, cap, scale, kernels=kernels, mesh=mesh,
            rounds_per_call=chunk,
        )
        return _HostCopy(packed)

    # A fresh split already holds the OLDEST `cap` valid seeds, so the
    # first round runs without a merge (FIFO order).  A resumed frontier is
    # a round's accepted output (the newest), so there the merge before the
    # first round is the FIFO order.
    skip_first_merge = not resumed
    pending = None  # an enqueued chunk whose payload is not read yet
    if not resumed:
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
            # ONE device->host copy for the whole seed stage, enqueued
            # before round 1 so that round 1 does not hold it up.
            seed_copy = _HostCopy(seed_packed)
        frontier, backlog = _split_frontier(seeds, cap)
        # Enqueue round 1 before the seed payload is read: it never needs
        # a merge, and the budget loop certainly runs it (n_seeds <=
        # num_tracks < max_patches).
        if (
            config.overlap_seed_fetch
            and config.max_rounds > 0
            and recon.num_tracks < config.max_patches
        ):
            pending = dispatch()
            skip_first_merge = False
        with timers.stage("seed"):
            # Colors are sampled on the host from the original images.
            sp = seed_copy.numpy()
            seed_valid, s_c, s_n, s_score, s_color = unpack_patch_payload(
                sp, images
            )
            n_seeds = int(seed_valid.sum())
            metrics.record("mvs_num_seeds", n_seeds)

        total = n_seeds
        rounds = 0
        dropped_candidates = 0
        # Exact live backlog count, tracked on the host with no device
        # read: the split kept the first `cap` valid rows, so n_seeds - cap
        # were deferred; each later merge updates it from the valid-row
        # count of the frontier folded back in (the JAX package's round-4
        # accounting).
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

    def save_state():
        host = lambda x: x.cpu().numpy()  # noqa: E731
        st = {
            "fingerprint": np.asarray(fingerprint),
            "occupancy": host(occupancy),
            "counters": np.asarray(
                [total, rounds, dropped_candidates, n_seeds], np.int64
            ),
            "acc_c": np.concatenate(all_c).astype(np.float32),
            "acc_n": np.concatenate(all_n).astype(np.float32),
            "acc_score": np.concatenate(all_score).astype(np.float32),
            "acc_color": np.concatenate(all_color),
            "acc_ref": np.concatenate(all_ref).astype(np.int32),
        }
        for k in _FRONTIER_KEYS:
            st["f_" + k] = host(frontier[k])
        if backlog:
            for k in _FRONTIER_KEYS:
                st["b_" + k] = host(backlog[k])
        ckpt.save_mvs_state(checkpoint_dir, _to_state_width(st, n_state))

    last_ckpt_rounds = rounds
    backlog_merge_s = 0.0
    backlog_rounds = 0
    hits_over_k = 0
    # Acceptance funnel, summed over rounds from the payload's tail row:
    # [scored, ray+finite, +coplanar+near, +NCC views, post-dedup accepts].
    funnel = np.zeros(5, np.int64)
    with timers.stage("expand"):
        while rounds < config.max_rounds and total < config.max_patches:
            if pending is None:
                if bl_count and not skip_first_merge:
                    # A device-side merge: the time is its issue cost.
                    t0 = time.perf_counter()
                    frontier, backlog = _merge_backlog(frontier, backlog, cap)
                    backlog_merge_s += time.perf_counter() - t0
                    backlog_rounds += 1
                    # The merge folds bl_count backlog rows + fr_valid
                    # frontier rows into the next frontier (capped at
                    # `cap`); the rest is the new backlog.
                    pending_rows = bl_count + fr_valid
                    bl_count = max(0, pending_rows - cap)
                    fr_valid = min(pending_rows, cap)
                    if bl_count == 0:
                        backlog = None
                skip_first_merge = False
                payload = dispatch()
            else:
                payload, pending = pending, None
            # Enqueue the NEXT chunk before this one's payload is read,
            # only where it is certainly the chunk the serial loop would
            # run: no backlog merge pending, neither budget reachable even
            # if every slot accepts (after this chunk rounds' = rounds +
            # chunk, total' <= total + chunk * cap), and no checkpoint due
            # (its state must match the counters).
            if (
                not bl_count
                and rounds + chunk < config.max_rounds
                and total + chunk * cap < config.max_patches
                and not (
                    checkpoint_dir
                    and rounds + 2 * chunk - last_ckpt_rounds
                    >= checkpoint_every
                )
            ):
                pending = dispatch()
            # ONE small copy per chunk; the frontier stays on the device.
            ph = payload.numpy().reshape(chunk, cap + 1, 11)
            stop = False
            for r in range(chunk):
                acc_valid, a_c, a_n, a_score, a_color = unpack_patch_payload(
                    ph[r, :cap], images
                )
                n_acc = int(acc_valid.sum())
                fr_valid = n_acc
                dropped_candidates += max(0, int(ph[r, cap, 0]) - cap)
                hits_over_k += int(ph[r, cap, 1])
                funnel += ph[r, cap, 2:7].astype(np.int64)
                rounds += 1
                if n_acc == 0:
                    # Frontier dry: deferred patches (if any) refill it at
                    # the next merge, so stop only when the backlog is
                    # empty too.  The chunk's later rounds accept nothing.
                    stop = bl_count == 0
                    break
                all_c.append(a_c[acc_valid])
                all_n.append(a_n[acc_valid])
                all_score.append(a_score[acc_valid])
                all_color.append(a_color[acc_valid])
                all_ref.append(_payload_refs(ph[r, :cap][acc_valid], n))
                total += n_acc
                # The budgets hold mid-chunk too.
                if rounds >= config.max_rounds or total >= config.max_patches:
                    stop = True
                    break
            if checkpoint_dir and rounds - last_ckpt_rounds >= checkpoint_every:
                # Every process of a group mesh holds this state: process 0
                # writes it, and the others wait until the file is whole.
                if mesh.process_index == 0:
                    save_state()
                mesh.barrier()
                last_ckpt_rounds = rounds
            if stop:
                break
    if checkpoint_dir:
        # Completed: the mid-run state is superseded by the stage output.
        if mesh.process_index == 0:
            ckpt.clear_mvs_state(checkpoint_dir)
        mesh.barrier()
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

    points = np.concatenate(all_c).astype(np.float32)
    colors = np.concatenate(all_color).astype(np.uint8)
    normals = np.concatenate(all_n).astype(np.float32)
    scores = np.concatenate(all_score).astype(np.float32)
    refs = np.concatenate(all_ref).astype(np.int32)

    if config.enable_outlier_filter:
        # Each patch's visibility is a deterministic function of (centre,
        # reference image, threshold) through the scoring sweep the rounds
        # used, so it is recomputed on the device in one final batch
        # instead of being carried per round; the host reads one keep mask.
        with timers.stage("filter"):
            keep = _run_device_filter(
                mesh, *shards, points, normals, scores, refs, n_seeds,
                h, w, config, metrics, kernels=kernels,
            )
        metrics.record("mvs_filtered_out", int((~keep).sum()))
        points, colors = points[keep], colors[keep]
        normals, scores = normals[keep], scores[keep]
        refs = refs[keep]
        n_seeds = int(keep[:n_seeds].sum())
        metrics.record("mvs_num_points_filtered", points.shape[0])

    return DenseReconstruction(
        points=points,
        colors=colors,
        normals=normals,
        scores=scores,
        refs=refs,
        num_seeds=n_seeds,
        metrics=metrics,
        timers=timers,
    )
