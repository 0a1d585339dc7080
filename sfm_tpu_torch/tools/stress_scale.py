"""Scale stress beyond dinoRing: a 96-frame 1280x960 textured-sphere ring
through SfM, bundle adjustment and MVS.

Counterpart of ``tools/stress_scale.py``: the same scene (``make_scene``:
``ring_rig(96)``, seed 0, texture frequency scale pinned to 1.0), flags,
defaults and configuration (``max_rounds`` 96, MVS ``scale`` 10), at twice
dinoRing's frames and four times its pixels a frame.  It holds the static
capacities (corners, matches, MVS round capacity and backlog) at that
scale against the sphere's exact geometry.

Run on a machine with an NVIDIA GPU (``--device cpu`` runs the plain
versions on the host; keep the flags small there):

    python3 -m sfm_tpu_torch.tools.stress_scale [--frames 96] [--width 1280]
        [--height 960] [--max_corners 4096] [--max_matches 2048]
        [--round_capacity 32768] [--max_patches 300000] [--device cuda]
        [--warm 1] [--out PATH]

Prints the kernels' build time (on the card; the cold run then times the
pipeline, not the compilers), one JSON line for the scene
(``scene_gen_s``, ``shape``), one per stage, a ``RESULT`` line, one ``WARM`` line per repeat, and a ``KERNELS``
line: K1's and K2's kernel-only device ms at this scale beside their bytes
bounds (``tools/measure.py``).  ``--out`` writes an artifact with the
quality gates (``GATES``) and exits 1 when one fails.  The JAX tool's
``matcher_mfu`` is a TPU roofline figure and is not ported (the artifact
says so under ``not_ported``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from sfm_tpu_torch.ba import bundle_adjust
from sfm_tpu_torch.config import FeatureConfig, MvsConfig, PipelineConfig, RuntimeConfig
from sfm_tpu_torch.io.images import device_gray
from sfm_tpu_torch.mvs import dense_reconstruction
from sfm_tpu_torch.ops.gather import sample_normalized_patches
from sfm_tpu_torch.ops.harris import detect_corners, harris_response
from sfm_tpu_torch.sfm import structure_from_motion
from sfm_tpu_torch.tools.measure import gather_bound, harris_bound, kernel_only_ms
from sfm_tpu_torch.utils import build, synth

# The quality envelope of the JAX tool's artifact (tools/stress_scale.py:
# 178-184), less its TPU matcher-MFU gate.
GATES = {
    "dense_points_min": 290_000,
    "sphere_dist_median_max": 0.013,
    "sphere_dist_p95_max": 0.045,
    "backlog_remaining_max": 0,
}
NOT_PORTED = ["matcher_mfu"]
MVS_SCALE = 10.0
MVS_MAX_ROUNDS = 96


def make_scene(n_frames=96, w=1280, h=960, seed=0):
    """The textured-sphere ring, as ``tools/stress_scale.py:make_scene``
    renders it (``texture_freq_scale`` pinned to 1.0), on the host's
    threads.  Returns (images uint8 (N, H, W, 3), Calibration)."""
    return synth.render_scene(synth.ring_rig(n_frames), w=w, h=h, seed=seed,
                              texture_freq_scale=1.0)


def stress_config(max_corners=4096, max_matches=2048, round_capacity=32768,
                  max_patches=300_000, device="cuda") -> PipelineConfig:
    """The JAX tool's configuration (:79-89) on ``device``."""
    return PipelineConfig(
        features=FeatureConfig(max_corners=max_corners, max_matches=max_matches),
        mvs=MvsConfig(round_capacity=round_capacity, max_patches=max_patches,
                      max_rounds=MVS_MAX_ROUNDS),
        runtime=RuntimeConfig(device=device),
    )


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _reset_peak(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def _peak(device):
    """Peak device bytes since the last reset (None on the host)."""
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else None


def _launches():
    return {"harris_response": harris_response.launches,
            "sample_normalized_patches": sample_normalized_patches.launches}


def _zero_launches():
    harris_response.launches = sample_normalized_patches.launches = 0


def sphere_distance(points):
    """|‖p‖ - 1| of each point: its distance to the unit sphere."""
    return np.abs(np.linalg.norm(points, axis=1) - 1.0)


def run_stages(images, calib, cfg, emit=print):
    """SfM, BA and MVS once, each on the card's clock (ending in a sync),
    with K1 / K2 launches counted from 0 and the peak device memory reset
    before each stage; prints one JSON line a stage.  Returns a dict with
    the stage results (``recon``, ``info``, ``dense``) and walls."""
    device = torch.device(cfg.runtime.device)
    out = {}
    _reset_peak(device)
    _zero_launches()
    _sync(device)
    t0 = time.perf_counter()
    recon = structure_from_motion(images, calib, cfg)
    _sync(device)
    out["sfm_s"] = time.perf_counter() - t0
    mv = recon.metrics.values
    out["sfm"] = {
        "stage": "sfm", "wall_s": round(out["sfm_s"], 4),
        "tracks": recon.num_tracks, "obs": int(recon.num_observations),
        "mean_pair_reproj": mv["mean_pair_reprojection_error_px"],
        "pair_chunks": mv["pair_chunks"], "peak_device_bytes": _peak(device),
        "launches": _launches(),
        "timers": {k: round(v, 4) for k, v in recon.timers.times.items()},
    }
    emit(json.dumps(out["sfm"]))

    rms_before = recon.rms_reprojection_error()
    _reset_peak(device)
    _zero_launches()
    t0 = time.perf_counter()
    recon, info = bundle_adjust(recon, cfg.ba, device=device)
    _sync(device)
    out["ba_s"] = time.perf_counter() - t0
    out["rms_px"] = recon.rms_reprojection_error()
    out["ba"] = {"stage": "ba", "wall_s": round(out["ba_s"], 4),
                 "rms_px": out["rms_px"], "rms_before_px": rms_before,
                 "iters": info["iterations"],
                 "peak_device_bytes": _peak(device), "launches": _launches()}
    emit(json.dumps(out["ba"]))

    _reset_peak(device)
    _zero_launches()
    t0 = time.perf_counter()
    dense = dense_reconstruction(images, calib, recon, cfg.mvs, scale=MVS_SCALE,
                                 device=device)
    _sync(device)
    out["mvs_s"] = time.perf_counter() - t0
    dm = dense.metrics.values
    out["mvs"] = {
        "stage": "mvs", "wall_s": round(out["mvs_s"], 4),
        "seeds": dense.num_seeds, "dense_points": dense.num_points,
        "rounds": dm["mvs_rounds"],
        "mvs_candidates_over_capacity": dm["mvs_candidates_over_capacity"],
        "mvs_backlog_remaining": dm.get("mvs_backlog_remaining", 0),
        "mvs_backlog_rounds": dm.get("mvs_backlog_rounds", 0),
        "peak_device_bytes": _peak(device), "launches": _launches(),
        "timers": {k: round(v, 4) for k, v in dense.timers.times.items()},
    }
    emit(json.dumps(out["mvs"]))
    out.update(recon=recon, info=info, dense=dense)
    return out


def run_launches(run) -> dict:
    """K1 / K2 launches of one pass of ``run_stages``, over its stages."""
    return {k: sum(run[s]["launches"][k] for s in ("sfm", "ba", "mvs"))
            for k in run["sfm"]["launches"]}


def result_record(run, frames, width, height) -> dict:
    """The JAX tool's RESULT keys (:113-130) plus the pair chunks and the
    largest stage's peak device bytes."""
    wall = run["sfm_s"] + run["ba_s"] + run["mvs_s"]
    dense, dm = run["dense"], run["dense"].metrics.values
    r_err = sphere_distance(dense.points)
    peaks = [run[s]["peak_device_bytes"] for s in ("sfm", "ba", "mvs")]
    return {
        "frames": frames, "res": f"{width}x{height}",
        "sfm_s": round(run["sfm_s"], 4), "ba_s": round(run["ba_s"], 4),
        "mvs_s": round(run["mvs_s"], 4), "wall_s": round(wall, 4),
        "frames_per_s": round(frames / wall, 4),
        "tracks": run["recon"].num_tracks,
        "rms_px": round(run["rms_px"], 4),
        "seeds": dense.num_seeds,
        "dense_points": dense.num_points,
        "rounds": dm["mvs_rounds"],
        "sphere_dist_median": float(np.median(r_err)),
        "sphere_dist_p95": float(np.percentile(r_err, 95)),
        "candidates_over_capacity": dm["mvs_candidates_over_capacity"],
        "backlog_remaining": dm.get("mvs_backlog_remaining", 0),
        "pair_chunks": run["sfm"]["pair_chunks"],
        "peak_device_bytes": None if None in peaks else max(peaks),
    }


def warm_record(run, frames) -> dict:
    wall = run["sfm_s"] + run["ba_s"] + run["mvs_s"]
    return {"sfm_s": round(run["sfm_s"], 4), "ba_s": round(run["ba_s"], 4),
            "mvs_s": round(run["mvs_s"], 4), "wall_s": round(wall, 4),
            "frames_per_s": round(frames / wall, 4),
            "dense_points": run["dense"].num_points}


def check_gates(result, dense_points_runs):
    """The artifact's checks: the dense points of every run (cold and
    warm), the sphere-distance envelope and the backlog against ``GATES``.
    Returns (checks, passed)."""
    checks = {
        "dense_points": min(dense_points_runs) >= GATES["dense_points_min"],
        "sphere_dist_median":
            result["sphere_dist_median"] <= GATES["sphere_dist_median_max"],
        "sphere_dist_p95":
            result["sphere_dist_p95"] <= GATES["sphere_dist_p95_max"],
        "backlog_remaining":
            result["backlog_remaining"] <= GATES["backlog_remaining_max"],
    }
    return checks, all(checks.values())


def feature_samples(gray, fc: FeatureConfig):
    """The integer centres SfM hands K2 for its descriptors (as
    ``features.frontend.detect_and_describe``): every image's top-K corner
    slots, flattened.  Returns (img (N K,) int32, centres (N K, 2) f32)."""
    corners, _, _ = detect_corners(
        gray, max_corners=fc.max_corners, nms_radius=fc.nms_radius,
        rel_threshold=fc.harris_rel_threshold, border=fc.desc_wid + 1,
        k=fc.harris_k)
    n, k = corners.shape[:2]
    img = (torch.arange(n, dtype=torch.int32, device=gray.device)[:, None]
           .expand(n, k).reshape(-1).contiguous())
    return img, corners.reshape(-1, 2).float().contiguous()


def kernel_record(images, cfg, launches) -> dict:
    """K1 on the whole gray stack and K2 at the SfM descriptors' centres:
    kernel-only device ms (not measured on the host) beside each call's
    bytes bound, and ``launches`` (``run_launches`` of the cold run)."""
    device = torch.device(cfg.runtime.device)
    fc = cfg.features
    gray = device_gray(images, device)
    stack = gray.to(torch.bfloat16)
    img, ctr = feature_samples(gray, fc)
    on_card = device.type == "cuda"
    k1 = {"shape": list(gray.shape), **harris_bound(gray.numel()),
          "launches": launches["harris_response"],
          "kernel_only_ms": kernel_only_ms(
              lambda: harris_response(gray, fc.harris_k), "harris_kernel")
          if on_card else None}
    k2 = {"samples": img.numel(), "shape": list(stack.shape),
          **gather_bound(stack.numel(), img.numel(), fc.desc_wid),
          "launches": launches["sample_normalized_patches"],
          "kernel_only_ms": kernel_only_ms(
              lambda: sample_normalized_patches(stack, img, ctr, fc.desc_wid),
              "gather_kernel") if on_card else None}
    rec = {"harris_response": k1, "sample_normalized_patches": k2}
    if not on_card:
        rec["note"] = f"kernel-only times not measured: device {device}"
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=960)
    ap.add_argument("--max_corners", type=int, default=4096)
    ap.add_argument("--max_matches", type=int, default=2048)
    ap.add_argument("--round_capacity", type=int, default=32768)
    ap.add_argument("--max_patches", type=int, default=300_000)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--warm", type=int, default=1,
                    help="repeats of the whole pipeline after the cold run")
    ap.add_argument("--out", default=None,
                    help="write the artifact with its gates; exit 1 when "
                         "one fails")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("error: no CUDA device (use --device cpu for the plain "
                  "versions)", file=sys.stderr)
            return 1
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
        # Built before the cold run, so that it times the pipeline and not
        # the compilers.
        t0 = time.perf_counter()
        build.kernel_library()
        build.trackstore_library()
        print(json.dumps({"build_s": round(time.perf_counter() - t0, 2)}),
              flush=True)

    t0 = time.perf_counter()
    images, calib = make_scene(args.frames, args.width, args.height)
    print(json.dumps({"scene_gen_s": round(time.perf_counter() - t0, 2),
                      "shape": list(images.shape),
                      "threads": os.cpu_count()}), flush=True)
    cfg = stress_config(args.max_corners, args.max_matches,
                        args.round_capacity, args.max_patches, args.device)
    emit = lambda s: print(s, flush=True)  # noqa: E731
    run = run_stages(images, calib, cfg, emit)
    result = result_record(run, args.frames, args.width, args.height)
    print("RESULT " + json.dumps(result), flush=True)
    warm = []
    for _ in range(args.warm):
        warm.append(warm_record(run_stages(images, calib, cfg, lambda s: None),
                                args.frames))
        print("WARM " + json.dumps(warm[-1]), flush=True)
    kernels = kernel_record(images, cfg, run_launches(run))
    print("KERNELS " + json.dumps(kernels), flush=True)

    if args.out:
        checks, passed = check_gates(
            result, [result["dense_points"]] + [w["dense_points"] for w in warm])
        artifact = {
            "config": {
                "frames": args.frames, "res": f"{args.width}x{args.height}",
                "max_corners": args.max_corners,
                "max_matches": args.max_matches,
                "round_capacity": args.round_capacity,
                "max_patches": args.max_patches,
            },
            "device": (torch.cuda.get_device_name(device)
                       if device.type == "cuda" else str(device)),
            "cold": result,
            "warm": warm,
            "kernels": kernels,
            "gates": GATES,
            "checks": checks,
            "not_ported": NOT_PORTED,
            "pass": passed,
        }
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {args.out} (pass={passed})", flush=True)
        if not passed:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
