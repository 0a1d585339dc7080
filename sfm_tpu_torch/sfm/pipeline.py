"""Sparse reconstruction pipeline.

Counterpart of ``sfm_tpu/sfm/pipeline.py``.  Features for the whole stack
are detected in one batched call (kernels K1 and K2 on CUDA); then every
pair goes through match -> RANSAC -> triangulate -> two-view gate as one
batched tensor program with a leading pair axis (the JAX package maps the
same step over pairs).  Only the track-store merge (hash-based,
order-dependent) runs on the host, pair by pair in schedule order.

The pair program runs over chunks of the pair axis, each sized so that
its working set stays under a quarter of the device's memory
(``pairs_per_chunk``): all-pairs mode (``pair_mode="combination"``, C(n, 2)
pairs) would otherwise need memory in proportion to n^2.  The JAX package
bounds it the same way with a ``lax.map`` over the pairs.  Chunks are
independent, so any chunk size gives the same reconstruction.

Feature detection is split over the image axis of a mesh
(``parallel.DataMesh``) and the pair program over the pair axis, each shard
on its own device (both are embarrassingly parallel), chunked inside each
shard, and the results are gathered on the lead device before the track
store: the same reconstruction whatever the mesh.  A run without a mesh is
a mesh of its one device.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.features.frontend import FeatureSet, detect_and_describe
from sfm_tpu_torch.features.matching import (
    match_descriptors,
    match_pair_gate,
    matched_points,
)
from sfm_tpu_torch.geometry.projection import project_pinhole, projection_matrix
from sfm_tpu_torch.geometry.triangulation import (
    refine_triangulation,
    triangulate_dlt,
)
from sfm_tpu_torch.io.calib import Calibration
from sfm_tpu_torch.io.images import device_gray
from sfm_tpu_torch.ops._launch import use_kernel
from sfm_tpu_torch.parallel.mesh import DataMesh
from sfm_tpu_torch.sfm.ransac import (
    draw_uniforms,
    ransac_fundamental,
    samples_from_uniforms,
)
from sfm_tpu_torch.sfm.tracks import TrackStore
from sfm_tpu_torch.utils.metrics import Metrics, StageTimer


def pair_schedule(n: int, mode: str = "sequence") -> List[Tuple[int, int]]:
    """'sequence': chained (i-1, i) pairs; 'combination': all C(n, 2)."""
    if mode == "sequence":
        return [(i - 1, i) for i in range(1, n)]
    if mode == "combination":
        return [(i, j) for i in range(n) for j in range(i + 1, n)]
    raise ValueError(f"unknown pair mode: {mode}")


@dataclass
class SparseReconstruction:
    """Output of sparse SfM: tracks + cameras + diagnostics."""

    calib: Calibration
    world: np.ndarray          # (T, 3) float64 track points
    track_offsets: np.ndarray  # (T+1,) int64
    track_obs: np.ndarray      # (O, 3) int32 rows (image, x, y)
    metrics: Metrics = field(default_factory=Metrics)
    # The reconstruction's trace: SfM's spans, then BA's and MVS's.
    timers: Optional[StageTimer] = None
    debug_pairs: Optional[dict] = None

    @property
    def num_tracks(self) -> int:
        return self.world.shape[0]

    @property
    def num_observations(self) -> int:
        return self.track_obs.shape[0]

    def track_lengths(self) -> np.ndarray:
        return np.diff(self.track_offsets)

    def reprojection_errors(self) -> np.ndarray:
        """Per-observation pixel error of the track points (float64, host)."""
        point_idx = np.repeat(np.arange(self.num_tracks), self.track_lengths())
        cam = self.track_obs[:, 0]
        t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
        proj = project_pinhole(
            t(self.world[point_idx]), t(self.calib.K[cam]),
            t(self.calib.R[cam]), t(self.calib.t[cam]),
        ).numpy()
        return np.linalg.norm(proj - self.track_obs[:, 1:3], axis=-1)

    def mean_reprojection_error(self) -> float:
        if self.num_observations == 0:
            return float("nan")
        return float(self.reprojection_errors().mean())

    def rms_reprojection_error(self) -> float:
        if self.num_observations == 0:
            return float("nan")
        e = self.reprojection_errors()
        return float(np.sqrt(np.mean(e * e)))

    def export_ply(self, path: str) -> None:
        from sfm_tpu_torch.io.ply import export_ply

        export_ply(path, self.world.astype(np.float32))


def pair_geometry(fs, ia, ib, K, R, t, config: PipelineConfig,
                  samples=None, uniforms=None, real=None):
    """The per-pair step for all pairs at once (leading pair axis P).

    fs: FeatureSet of the stack; ia, ib: (P,) image indices; K, R, t: the
    stack's f32 cameras.  RANSAC takes ``samples`` (P, H, 8) as given, or
    maps ``uniforms`` (P, H*8) onto each pair's valid matches
    (``samples_from_uniforms``).  ``real`` (P,) bool masks pad pairs: their
    features count as invalid.  Returns (geo (P, M, 8) [p1 | p2 | X | ok],
    stats (P, 4) [matches, inliers, gated, err_sum], F (P, 3, 3)).
    """
    fc, rc, sc = config.features, config.ransac, config.sfm
    val_a, val_b = fs.valid[ia], fs.valid[ib]
    if real is not None:
        val_a = val_a & real[:, None]
        val_b = val_b & real[:, None]
    m = match_descriptors(
        fs.descriptors[ia], val_a, fs.descriptors[ib], val_b,
        lowe_ratio=fc.lowe_ratio, max_matches=fc.max_matches,
        mutual_check=fc.mutual_check,
    )
    p1, p2 = matched_points(fs.corners[ia], fs.corners[ib], m)
    valid = m.valid & match_pair_gate(m, fc.min_matches)[:, None]
    if samples is None:
        samples = samples_from_uniforms(valid, uniforms)
    F, inliers, n_inl = ransac_fundamental(
        p1, p2, valid, samples=samples, threshold_px=rc.inlier_threshold_px,
        refit=rc.refit_on_inliers,
    )
    P = projection_matrix(K, R, t)
    Pab = torch.stack([P[ia], P[ib]], dim=1)  # (P, 2, 3, 4)
    Pm = Pab[:, None].expand(-1, p1.shape[1], -1, -1, -1)
    pix = torch.stack([p1, p2], dim=2)  # (P, M, 2, 2)
    X, w = triangulate_dlt(Pm, pix)
    X = refine_triangulation(Pm, pix, X)
    nondegenerate = w.abs() > 1e-9

    def err(Kc, Rc, tc, p):
        proj = project_pinhole(X, Kc[:, None], Rc[:, None], tc[:, None])
        d = proj - p
        return torch.sqrt(torch.sum(d * d, dim=-1))

    err_a = err(K[ia], R[ia], t[ia], p1)
    err_b = err(K[ib], R[ib], t[ib], p2)
    gate = (err_a <= sc.max_reprojection_error_px) & (
        err_b <= sc.max_reprojection_error_px
    )
    ok = inliers & nondegenerate & gate
    zero = torch.zeros_like(err_a)
    err_sum = torch.where(ok, 0.5 * (err_a + err_b), zero).sum(dim=-1)
    geo = torch.cat([p1, p2, X.float(), ok.float()[..., None]], dim=-1)
    stats = torch.stack(
        [m.count.float(), n_inl.float(), ok.sum(dim=-1).float(), err_sum],
        dim=-1,
    )
    return geo, stats, F


# Floats one pair holds at the peak of ``pair_geometry``, per element of its
# largest intermediates: RANSAC's (H, M) hypothesis-by-match tensors (the
# one-hot weights, the normalised points, the nine columns of the 8-point
# design matrix and its weighted copy, then the Sampson lines) and
# matching's (K, K) score matrices.  The two peaks do not overlap in time.
_HM_FLOATS = 32
_KK_FLOATS = 6


def pair_working_bytes(config: PipelineConfig) -> int:
    """Peak bytes one pair adds to ``pair_geometry``, from the shapes the
    configuration gives it: H hypotheses, M matches, K corners and
    descriptors of D values (the two images' descriptors gathered too)."""
    fc = config.features
    h, m, k = config.ransac.num_hypotheses, fc.max_matches, fc.max_corners
    d = (2 * fc.desc_wid + 1) ** 2
    return 4 * (max(_HM_FLOATS * h * m, _KK_FLOATS * k * k) + 2 * k * d
                + 16 * m)


def chunk_budget_bytes(device: torch.device) -> int:
    """Bytes a chunk of the pair program may take on ``device``: a quarter
    of its memory (the host's for the CPU)."""
    if device.type == "cuda":
        total = torch.cuda.get_device_properties(device).total_memory
    else:
        total = os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES")
    return total // 4


def pairs_per_chunk(config: PipelineConfig, device: torch.device) -> int:
    """Pairs in one chunk of the pair program on ``device`` (at least 1)."""
    return max(1, chunk_budget_bytes(device) // pair_working_bytes(config))


def _pair_geometry_on_mesh(fs, ia, ib, K, R, t, config, samples, uniforms,
                           mesh):
    """``pair_geometry`` with the pair axis split over ``mesh`` and each
    shard's pairs run in chunks of ``pairs_per_chunk``: features and cameras
    replicated per device, pad pairs (0, 0) masked invalid (``real``) with
    zero draws, the draws sliced like the pairs, the outputs gathered on the
    lead device without the pad rows.  Returns (geo, stats, F, chunks)."""
    n_pairs = ia.shape[0]
    real = torch.ones(n_pairs, dtype=torch.bool, device=ia.device)
    draws = samples if samples is not None else uniforms
    given = "samples" if samples is not None else "uniforms"
    split = [mesh.split(x) for x in (ia, ib, real, draws)]
    reps = [mesh.replicate(x) for x in
            (fs.corners, fs.valid, fs.descriptors, K, R, t)]
    outs, chunks = [], 0
    for (ia_s, ib_s, real_s, draws_s), (cor, val, desc, K_s, R_s, t_s) in zip(
            zip(*split), zip(*reps)):
        step = pairs_per_chunk(config, ia_s.device)
        parts = []
        for c in range(0, max(ia_s.shape[0], 1), step):
            parts.append(pair_geometry(
                FeatureSet(cor, val, desc), ia_s[c:c + step], ib_s[c:c + step],
                K_s, R_s, t_s, config, real=real_s[c:c + step],
                **{given: draws_s[c:c + step]},
            ))
        chunks += len(parts)
        outs.append(tuple(torch.cat(x) for x in zip(*parts)))
    return (*(mesh.gather(list(x), n_pairs) for x in zip(*outs)), chunks)


def structure_from_motion(
    images: np.ndarray,
    calib: Calibration,
    config: PipelineConfig = PipelineConfig(),
    track_store: Optional[TrackStore] = None,
    ransac_samples: Optional[torch.Tensor] = None,
    mesh=None,
) -> SparseReconstruction:
    """Run sparse SfM over a uint8 RGB (N, H, W, 3) stack with known
    calibration on ``config.runtime.device``.

    As in the reference, camera poses come from the calibration; RANSAC
    rejects outlier matches.  ``ransac_samples`` (P, H, 8) fixes the RANSAC
    hypotheses per pair (tests feed the JAX package's draws); otherwise they
    are drawn from a generator seeded with ``config.runtime.seed``, once for
    all pairs before any split, so a mesh of any size draws the same.

    With ``mesh`` (a ``parallel.DataMesh``) the stage runs on ``mesh.lead``
    (``config.runtime.device`` is not read): features shard over images
    (the image axis padded with zero images to a multiple of the shards,
    recorded as ``features_image_axis_padded``) and the pair program over
    pairs (pad pairs (0, 0), masked invalid and dropped before the track
    store).
    """
    timers = StageTimer()
    metrics = Metrics()
    n = images.shape[0]
    if calib.num_views < n:
        raise ValueError(
            f"{n} images but only {calib.num_views} calibrated cameras"
        )
    if mesh is not None:
        metrics.record("mesh_devices", mesh.size)
    device = mesh.lead if mesh is not None else torch.device(config.runtime.device)
    mesh = mesh or DataMesh([device])
    pairs = pair_schedule(n, config.sfm.pair_mode)
    n_pairs = len(pairs)
    ia = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=device)
    ib = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=device)

    with timers.stage("features"):
        with timers.stage("gray"):
            gray = device_gray(images, device, config.runtime.kernels, metrics)
        kernels = use_kernel(gray, config.runtime.kernels)
        pad = (-n) % mesh.size
        if pad:
            metrics.record("features_image_axis_padded", pad)
        # Zero pad images: their Harris response is 0 everywhere, so they
        # keep no corner and no valid descriptor.
        parts = [detect_and_describe(g, config.features, kernels=kernels)
                 for g in mesh.split(gray)]
        fs = FeatureSet(*(
            mesh.gather([getattr(p, k) for p in parts], n)
            for k in ("corners", "valid", "descriptors")
        ))
        if device.type == "cuda":
            for d in dict.fromkeys(mesh.local_devices):
                torch.cuda.synchronize(d)  # attribute feature time here

    with timers.stage("pair_geometry"):
        cams = calib.subset(range(n))
        K, R, t = (
            torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (cams.K, cams.R, cams.t)
        )
        uniforms = None
        if ransac_samples is None:
            gen = torch.Generator().manual_seed(config.runtime.seed)
            uniforms = draw_uniforms((n_pairs,), config.ransac.num_hypotheses, gen)
        geo_d, stats_d, F_d, chunks = _pair_geometry_on_mesh(
            fs, ia, ib, K, R, t, config, ransac_samples, uniforms, mesh,
        )
        geo = geo_d.cpu().numpy()
        stats = stats_d.cpu().numpy()
        p1_h = geo[..., 0:2].astype(np.int32)
        p2_h = geo[..., 2:4].astype(np.int32)
        X_h = geo[..., 4:7].astype(np.float64)
        ok_h = geo[..., 7] > 0.5
        n_match, n_inl, n_gate, err_sum = (stats[:, i] for i in range(4))

    with timers.stage("tracks"):
        store = track_store or TrackStore(config.sfm.track_merge_threshold)
        for pi, (a, b) in enumerate(pairs):
            sel = ok_h[pi]
            if not sel.any():
                continue
            cnt = int(sel.sum())
            obs_a = np.concatenate(
                [np.full((cnt, 1), a, np.int32), p1_h[pi][sel]], axis=1
            )
            obs_b = np.concatenate(
                [np.full((cnt, 1), b, np.int32), p2_h[pi][sel]], axis=1
            )
            store.add_pairs(obs_a, obs_b, X_h[pi][sel])
        world, offsets, obs = store.export()

    n_gate_total = int(n_gate.sum())
    metrics.record("num_pairs", n_pairs)
    metrics.record("pair_chunks", chunks)
    metrics.record("matches_per_pair_mean", float(n_match.mean()))
    metrics.record("inliers_per_pair_mean", float(n_inl.mean()))
    metrics.record("gated_points_total", n_gate_total)
    metrics.record(
        "mean_pair_reprojection_error_px",
        float(err_sum.sum() / max(n_gate_total, 1)),
    )
    metrics.record("num_tracks", world.shape[0])
    metrics.record("num_observations", obs.shape[0])
    metrics.record("track_store_backend", store.backend)
    metrics.record("device", str(device))
    metrics.record("kernels", kernels)

    debug_pairs = None
    if config.debug:
        debug_pairs = {
            "pairs": pairs,
            "p1": geo[..., 0:2].astype(np.float32),
            "p2": geo[..., 2:4].astype(np.float32),
            "inlier": ok_h,
            "F": F_d.cpu().numpy(),
        }

    return SparseReconstruction(
        calib=calib, world=world, track_offsets=offsets, track_obs=obs,
        metrics=metrics, timers=timers, debug_pairs=debug_pairs,
    )
