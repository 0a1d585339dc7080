"""The system under test: one reconstruction through ``sfm_tpu_torch``,
the call sequence of its CLI (``cli.py:_main`` with ``--stages``) without
the CLI's file I/O (image decode, stage files, PLY writes).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np
import torch


def pipeline_config(config: dict, job: dict, device, seed: int):
    """The program's ``PipelineConfig`` from a configuration file's
    ``pipeline`` block and a cell's job: every knob that changes the
    result is given, the scheduling knobs are the program's defaults.
    ``seed`` seeds the program's RANSAC draws (``RuntimeConfig.seed``)."""
    from sfm_tpu_torch.config import (
        BaConfig, FeatureConfig, MvsConfig, PipelineConfig, RansacConfig,
        RuntimeConfig, SfmConfig,
    )

    p = config["pipeline"]
    return PipelineConfig(
        scale=job["mvs_scale"],
        features=FeatureConfig(**p["features"]),
        ransac=RansacConfig(**p["ransac"]),
        sfm=SfmConfig(**p["sfm"], pair_mode=job["pair_mode"]),
        ba=BaConfig(**p["ba"], refine_cameras=job["refine_cameras"]),
        mvs=MvsConfig(**p["mvs"]),
        runtime=RuntimeConfig(device=str(device), seed=seed),
    )


def calibration(K, R, t):
    """The program's ``Calibration`` of the scene's exact cameras."""
    from sfm_tpu_torch.io.calib import Calibration

    return Calibration(K=K, R=R, t=t,
                       names=tuple(f"s{i:04d}" for i in range(K.shape[0])))


def launch_counts():
    """(K1 launches, K2 launches) so far in this process: the program's
    own counters on its kernel wrappers."""
    from sfm_tpu_torch.ops.gather import sample_normalized_patches
    from sfm_tpu_torch.ops.harris import harris_response

    return harris_response.launches, sample_normalized_patches.launches


def load_libraries(device):
    """Load (and on a checkout's first run build) the program's kernel
    library and track store into its build directory."""
    from sfm_tpu_torch.utils import build

    if device.type == "cuda":
        build.kernel_library()
    if device.type == "cuda" or build.cxx_available():
        build.trackstore_library()


def run_pass(images, calib, config, job: dict, device, spans: bool = False):
    """One reconstruction of the uint8 RGB ``images``; returns its walls
    (``wall``, ``sfm_s``, ``ba_s`` and with MVS ``mvs_s``), the program's
    SfM stage timers and its outputs.  ``spans`` names the stages for the
    profiler (``bench.sfm``, ``bench.ba``, ``bench.mvs``)."""
    from sfm_tpu_torch.ba import bundle_adjust
    from sfm_tpu_torch.mvs import dense_reconstruction
    from sfm_tpu_torch.sfm import structure_from_motion

    if spans:
        from torch.profiler import record_function as span
    else:
        def span(_):
            return contextlib.nullcontext()
    mvs = "mvs" in job["stages"]
    t0 = time.perf_counter()
    with span("bench.sfm"):
        recon = structure_from_motion(images, calib, config)
    t1 = time.perf_counter()
    sfm_world = recon.world.copy()  # bundle_adjust refines recon in place
    with span("bench.ba"):
        recon, _ = bundle_adjust(recon, config.ba, device=device)
    t2 = time.perf_counter()
    dense = None
    if mvs:
        with span("bench.mvs"):
            dense = dense_reconstruction(
                images, recon.calib, recon, config.mvs,
                scale=config.scale, device=device,
                kernels=config.runtime.kernels)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t3 = time.perf_counter()
    out = {"world": sfm_world, "offsets": recon.track_offsets,
           "obs": recon.track_obs, "ba_world": recon.world}
    rec = {"wall": t3 - t0, "sfm_s": t1 - t0, "ba_s": t2 - t1,
           "timers": dict(recon.timers.times), "out": out}
    if mvs:
        rec["mvs_s"] = t3 - t2
        out["dense_points"] = dense.points
        out["dense_normals"] = dense.normals
    return rec


def fresh_copy(images: np.ndarray) -> np.ndarray:
    """A new host array with the scene's pixels, which no earlier pass
    saw."""
    return images.copy()
