"""Typed configuration for the whole pipeline.

The same frozen dataclass tree, field names and defaults as
``sfm_tpu/config.py`` (where each default's provenance is documented), so a
config reads the same in both packages.  The one difference is
``RuntimeConfig``: the JAX package's ``use_pallas`` becomes ``device`` plus
the ``kernels`` switch.  Fields that only drive JAX/TPU machinery
(``pairs_per_step``, ``shape_buckets``, ``rounds_per_call``,
``overlap_seed_fetch``) stay so configs carry over; nothing here reads them
(each one leaves the JAX package's output unchanged too).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional


@dataclass(frozen=True)
class FeatureConfig:
    """Corner detection + patch description + matching."""

    harris_k: float = 0.04
    harris_window: int = 3
    harris_rel_threshold: float = 1e-6
    nms_radius: int = 4
    max_corners: int = 1024
    desc_wid: int = 5
    lowe_ratio: float = 0.8
    min_matches: int = 8
    max_matches: int = 512
    mutual_check: bool = True


@dataclass(frozen=True)
class RansacConfig:
    """Fundamental-matrix RANSAC with a fixed batch of 8-point hypotheses."""

    num_hypotheses: int = 512
    inlier_threshold_px: float = 2.0
    refit_on_inliers: bool = True


@dataclass(frozen=True)
class SfmConfig:
    """Sparse reconstruction loop."""

    max_reprojection_error_px: float = 0.3
    track_merge_threshold: float = 0.01
    pair_mode: str = "sequence"
    pairs_per_step: int = 1  # JAX lax.map blocking; unused here


@dataclass(frozen=True)
class BaConfig:
    """Bundle adjustment: Levenberg-Marquardt (ba/), points-only by default.

    ``refine_cameras=True`` runs the joint solve; its reduced camera system
    is solved densely while the camera count is at most
    ``dense_schur_max_cams`` and both the JAX package's scatter-grid bytes
    and the port's same-point pair bytes are at most
    ``dense_schur_max_bytes``, and by PCG otherwise (``ba.run.dense_gate``).
    ``dense_schur_max_span`` is deprecated in both packages.
    """

    max_iterations: int = 50
    ftol: float = 1e-4
    gtol: float = 1e-8
    init_lambda: float = 1e-3
    lambda_up: float = 4.0
    lambda_down: float = 0.5
    refine_cameras: bool = False
    dtype: str = "float32"
    dense_schur_max_cams: int = 256
    dense_schur_max_bytes: int = 2 << 30
    dense_schur_max_span: int = 64


@dataclass(frozen=True)
class MvsConfig:
    """Patch-based dense reconstruction (mvs/)."""

    cell_size: int = 2
    patch_wid: int = 5
    min_ncc_seed: float = 0.4
    min_ncc_expand: float = 0.7
    visible_lower_bound: int = 3
    coplanarity_threshold: float = 0.1
    neighbor_radius_scaled: float = 0.05
    max_patches: int = 100_000
    max_rounds: int = 64
    round_capacity: int = 32_768
    rounds_per_call: int = 1
    max_photo_views: int = -1
    enable_outlier_filter: bool = False
    overlap_seed_fetch: bool = True
    shape_buckets: bool = True


def mvs_device_knobs(config: MvsConfig) -> MvsConfig:
    """The fields of ``config`` that change what a seed or expansion round
    computes (thresholds, patch/cell geometry, view gate), on top of the
    defaults; budgets, capacity and the scheduling toggles are host-loop
    knobs.  Same contract as ``sfm_tpu.config.mvs_device_knobs``."""
    return dataclasses.replace(
        MvsConfig(),
        cell_size=config.cell_size,
        patch_wid=config.patch_wid,
        min_ncc_seed=config.min_ncc_seed,
        min_ncc_expand=config.min_ncc_expand,
        visible_lower_bound=config.visible_lower_bound,
        coplanarity_threshold=config.coplanarity_threshold,
        neighbor_radius_scaled=config.neighbor_radius_scaled,
        max_photo_views=config.max_photo_views,
    )


def resolve_photo_views(max_photo_views: int, n_images: int) -> int:
    """Resolve ``MvsConfig.max_photo_views`` against the rig size.

    -1 (auto) -> 5 on rigs of >= 16 images, else 0 (score every view);
    explicit values pass through.  1 is rejected: it leaves no
    non-reference view to score.
    """
    if max_photo_views == 1:
        raise ValueError(
            "max_photo_views=1 leaves no non-reference view to score; "
            "use 0 (all views) or >= 2"
        )
    if max_photo_views < 0:
        return 5 if n_images >= 16 else 0
    return max_photo_views


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution environment knobs.

    ``device`` is where every tensor of the run lives.  ``kernels`` selects
    the hand-written CUDA kernels: None follows the device (on for CUDA, off
    for the CPU); True on a CPU device is an error; False on CUDA runs the
    plain PyTorch versions on the card (for stage-level comparison).
    ``mesh_shape`` is the CLI's ``--mesh_devices``: above 1, each stage runs
    over a mesh of that many devices (``cli.run_mesh``); the library
    functions take the mesh itself (``mesh=``).
    """

    mesh_shape: Optional[int] = None
    device: str = "cuda"
    kernels: Optional[bool] = None
    shape_buckets: bool = True
    checkpoint_dir: Optional[str] = None
    profile_dir: Optional[str] = None
    seed: int = 0


@dataclass(frozen=True)
class PipelineConfig:
    """Top-level configuration mirroring the reference CLI."""

    image_path: str = ""
    par_path: str = ""
    image_type: str = "ppm"
    scale: float = 1.0
    debug: bool = False
    max_images: Optional[int] = None

    features: FeatureConfig = field(default_factory=FeatureConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    sfm: SfmConfig = field(default_factory=SfmConfig)
    ba: BaConfig = field(default_factory=BaConfig)
    mvs: MvsConfig = field(default_factory=MvsConfig)
    runtime: RuntimeConfig = field(default_factory=RuntimeConfig)

    def replace(self, **kw) -> "PipelineConfig":
        return dataclasses.replace(self, **kw)


def _carry(cls, src, **extra):
    """Build ``cls`` from the same-named fields of ``src`` (any object)."""
    kw = {
        f.name: getattr(src, f.name)
        for f in dataclasses.fields(cls)
        if hasattr(src, f.name)
    }
    kw.update(extra)
    return cls(**kw)


def from_jax_config(cfg, device: str = RuntimeConfig.device) -> PipelineConfig:
    """Turn an ``sfm_tpu.config.PipelineConfig`` into this package's.

    Reads attributes only (no jax import).  ``runtime.use_pallas`` maps onto
    ``kernels``; ``device`` names where the port runs.
    """
    subs = {
        name: _carry(type(getattr(PipelineConfig(), name)), getattr(cfg, name))
        for name in ("features", "ransac", "sfm", "ba", "mvs")
    }
    runtime = _carry(
        RuntimeConfig, cfg.runtime, device=device,
        kernels=getattr(cfg.runtime, "use_pallas", None),
    )
    top = {
        f.name: getattr(cfg, f.name)
        for f in dataclasses.fields(PipelineConfig)
        if f.name not in subs and f.name != "runtime"
    }
    return PipelineConfig(**top, **subs, runtime=runtime)


def sparse_from_jax(recon):
    """Turn an ``sfm_tpu`` SparseReconstruction into this package's, from
    its numpy fields (``calib.K/R/t/names``, ``world``, ``track_offsets``,
    ``track_obs``): the state carried across, so one sparse result can feed
    both packages' BA and MVS.  Reads attributes only (no jax import)."""
    import numpy as np

    from sfm_tpu_torch.io.calib import Calibration
    from sfm_tpu_torch.sfm.pipeline import SparseReconstruction

    c = recon.calib
    return SparseReconstruction(
        calib=Calibration.from_numpy(c.K, c.R, c.t, c.names),
        world=np.array(recon.world, np.float64),
        track_offsets=np.array(recon.track_offsets, np.int64),
        track_obs=np.array(recon.track_obs, np.int32),
    )
