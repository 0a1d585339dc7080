"""Typed configuration for the whole pipeline.

The same frozen dataclass tree, field names and defaults as
``sfm_tpu/config.py`` (where each default's provenance is documented), so a
config reads the same in both packages.  The one difference is
``RuntimeConfig``: the JAX package's ``use_pallas`` becomes ``device`` plus
the ``kernels`` switch.  Fields that only drive JAX/TPU machinery
(``pairs_per_step``, ``shape_buckets``, ``rounds_per_call``,
``overlap_seed_fetch``) stay so configs carry over; nothing here reads them.
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
    """Bundle adjustment (not yet ported; fields kept for config parity)."""

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
    """Patch-based dense reconstruction (not yet ported; fields kept)."""

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


@dataclass(frozen=True)
class RuntimeConfig:
    """Execution environment knobs.

    ``device`` is where every tensor of the run lives.  ``kernels`` selects
    the hand-written CUDA kernels: None follows the device (on for CUDA, off
    for the CPU); True on a CPU device is an error; False on CUDA runs the
    plain PyTorch versions on the card (for stage-level comparison).
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
