"""Sparse reconstruction pipeline.

Counterpart of ``sfm_tpu/sfm/pipeline.py``.  Features for the whole stack
are detected in one batched call (kernels K1 and K2 on CUDA); then every
pair goes through match -> RANSAC -> triangulate -> two-view gate as one
batched tensor program with a leading pair axis (the JAX package maps the
same step over pairs).  Only the track-store merge (hash-based,
order-dependent) runs on the host, pair by pair in schedule order.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np
import torch

from sfm_tpu_torch.config import PipelineConfig
from sfm_tpu_torch.features.frontend import detect_and_describe
from sfm_tpu_torch.features.matching import match_descriptors
from sfm_tpu_torch.geometry.projection import project_pinhole, projection_matrix
from sfm_tpu_torch.geometry.triangulation import (
    refine_triangulation,
    triangulate_dlt,
)
from sfm_tpu_torch.io.calib import Calibration
from sfm_tpu_torch.io.images import device_gray
from sfm_tpu_torch.ops._launch import use_kernel
from sfm_tpu_torch.sfm.ransac import ransac_fundamental
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
                  samples=None, generator=None):
    """The per-pair step for all pairs at once (leading pair axis P).

    fs: FeatureSet of the stack; ia, ib: (P,) image indices; K, R, t: the
    stack's f32 cameras.  Returns (geo (P, M, 8) [p1 | p2 | X | ok],
    stats (P, 4) [matches, inliers, gated, err_sum], F (P, 3, 3)).
    """
    fc, rc, sc = config.features, config.ransac, config.sfm
    m = match_descriptors(
        fs.descriptors[ia], fs.valid[ia], fs.descriptors[ib], fs.valid[ib],
        lowe_ratio=fc.lowe_ratio, max_matches=fc.max_matches,
        mutual_check=fc.mutual_check,
    )
    cor_a = fs.corners[ia]
    cor_b = fs.corners[ib]

    def take(cor, idx):
        return torch.gather(cor, 1, idx.long()[..., None].expand(*idx.shape, 2))

    p1 = take(cor_a, m.idx1).float()
    p2 = take(cor_b, m.idx2).float()
    enough = m.count >= fc.min_matches
    F, inliers, n_inl = ransac_fundamental(
        p1, p2, m.valid & enough[:, None], samples=samples,
        num_hypotheses=rc.num_hypotheses, threshold_px=rc.inlier_threshold_px,
        refit=rc.refit_on_inliers, generator=generator,
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


def structure_from_motion(
    images: np.ndarray,
    calib: Calibration,
    config: PipelineConfig = PipelineConfig(),
    track_store: Optional[TrackStore] = None,
    ransac_samples: Optional[torch.Tensor] = None,
) -> SparseReconstruction:
    """Run sparse SfM over a uint8 RGB (N, H, W, 3) stack with known
    calibration on ``config.runtime.device``.

    As in the reference, camera poses come from the calibration; RANSAC
    rejects outlier matches.  ``ransac_samples`` (P, H, 8) fixes the RANSAC
    hypotheses per pair (tests feed the JAX package's draws); otherwise they
    are drawn from a generator seeded with ``config.runtime.seed``.
    """
    timers = StageTimer()
    metrics = Metrics()
    n = images.shape[0]
    if calib.num_views < n:
        raise ValueError(
            f"{n} images but only {calib.num_views} calibrated cameras"
        )
    device = torch.device(config.runtime.device)
    pairs = pair_schedule(n, config.sfm.pair_mode)
    ia = torch.tensor([p[0] for p in pairs], dtype=torch.long, device=device)
    ib = torch.tensor([p[1] for p in pairs], dtype=torch.long, device=device)

    with timers.stage("features"):
        gray = device_gray(images, device)
        kernels = use_kernel(gray, config.runtime.kernels)
        fs = detect_and_describe(gray, config.features, kernels=kernels)
        if device.type == "cuda":
            torch.cuda.synchronize(device)  # attribute feature time here

    with timers.stage("pair_geometry"):
        cams = calib.subset(range(n))
        K, R, t = (
            torch.from_numpy(a.astype(np.float32)).to(device)
            for a in (cams.K, cams.R, cams.t)
        )
        gen = torch.Generator().manual_seed(config.runtime.seed)
        geo_d, stats_d, F_d = pair_geometry(
            fs, ia, ib, K, R, t, config, samples=ransac_samples, generator=gen,
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
    metrics.record("num_pairs", len(pairs))
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
