"""Command-line entry point, counterpart of ``sfm_tpu/cli.py``.

Takes the same flags (plus ``--device``).  Only the SfM stage is ported:
``--stages sfm`` writes ``sparse_points.ply`` and prints the same summary
JSON keys; asking for ``ba`` or ``mvs`` exits with code 2.

Run: ``python -m sfm_tpu_torch.cli -img_p DIR -par_p DIR/x_par.txt -t png
--stages sfm [--device cuda]``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

PORTED_STAGES = ("sfm",)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="structure-from-motion + multi-view stereo "
                    "(PyTorch/CUDA port)"
    )
    p.add_argument("-img_p", "--image_path", required=True,
                   help="directory of input images")
    p.add_argument("-par_p", "--par_path", required=True,
                   help="Middlebury *_par.txt calibration file")
    p.add_argument("-t", "--type", default="ppm", dest="image_type",
                   help="image extension (default ppm, like the reference)")
    p.add_argument("-scale", type=float, default=1.0,
                   help="viz / MVS-radius scale multiplier")
    p.add_argument("--debug", action="store_true",
                   help="epipolar debug overlays (not yet ported)")
    p.add_argument("--nonSequence", action="store_true",
                   help="match all C(n,2) pairs instead of the sequential chain")
    p.add_argument("-cell_size", type=int, default=2)
    p.add_argument("-desc_wid", type=int, default=5)
    p.add_argument("--max_images", type=int, default=None)
    p.add_argument("--max_reproj_err", type=float, default=0.3)
    p.add_argument("--track_threshold", type=float, default=0.01)
    p.add_argument("--max_corners", type=int, default=1024)
    p.add_argument("--max_matches", type=int, default=512)
    p.add_argument("--lowe_ratio", type=float, default=0.8)
    p.add_argument("--min_ncc_seed", type=float, default=0.4)
    p.add_argument("--min_ncc_expand", type=float, default=0.7)
    p.add_argument("--mvs_rounds", type=int, default=64)
    p.add_argument("--mvs_round_capacity", type=int, default=32768)
    p.add_argument("--mvs_max_patches", type=int, default=100_000)
    p.add_argument("--mvs_max_views", type=int, default=-1)
    p.add_argument("--refine_cameras", action="store_true")
    p.add_argument("--enable_outlier_filter", action="store_true")
    p.add_argument("--no_shape_buckets", action="store_true")
    p.add_argument("--ba_dtype", default=None,
                   help="float32|float64 (default: f32 on cuda, f64 on cpu)")
    p.add_argument("--stages", default="sfm,ba,mvs",
                   help="comma list from {sfm,ba,mvs}; only sfm is ported")
    p.add_argument("--out_dir", default=".")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--mvs_checkpoint_every", type=int, default=16)
    p.add_argument("--mesh_devices", type=int, default=None)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--profile_dir", default=None)
    p.add_argument("--device", default="cuda",
                   help="torch device of the run (cuda runs the CUDA kernels)")
    return p


def config_from_args(args):
    from sfm_tpu_torch.config import (
        BaConfig, FeatureConfig, MvsConfig, PipelineConfig, RuntimeConfig,
        SfmConfig,
    )

    on_cuda = args.device.startswith("cuda")
    return PipelineConfig(
        image_path=args.image_path,
        par_path=args.par_path,
        image_type=args.image_type,
        scale=args.scale,
        debug=args.debug,
        max_images=args.max_images,
        features=FeatureConfig(
            max_corners=args.max_corners,
            max_matches=args.max_matches,
            lowe_ratio=args.lowe_ratio,
            desc_wid=args.desc_wid,
        ),
        sfm=SfmConfig(
            max_reprojection_error_px=args.max_reproj_err,
            track_merge_threshold=args.track_threshold,
            pair_mode="combination" if args.nonSequence else "sequence",
        ),
        ba=BaConfig(
            refine_cameras=args.refine_cameras,
            dtype=args.ba_dtype or ("float32" if on_cuda else "float64"),
        ),
        mvs=MvsConfig(
            cell_size=args.cell_size,
            patch_wid=args.desc_wid,
            min_ncc_seed=args.min_ncc_seed,
            min_ncc_expand=args.min_ncc_expand,
            max_rounds=args.mvs_rounds,
            round_capacity=args.mvs_round_capacity,
            max_patches=args.mvs_max_patches,
            max_photo_views=args.mvs_max_views,
            enable_outlier_filter=args.enable_outlier_filter,
            shape_buckets=not args.no_shape_buckets,
        ),
        runtime=RuntimeConfig(
            mesh_shape=args.mesh_devices,
            device=args.device,
            checkpoint_dir=args.checkpoint_dir,
            shape_buckets=not args.no_shape_buckets,
        ),
    )


def main(argv=None) -> int:
    """CLI entry point; bad input and pipeline errors exit 1 with a message,
    a stage that is not ported exits 2."""
    try:
        return _main(argv)
    except (RuntimeError, FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    missing = [s for s in stages if s not in PORTED_STAGES]
    if missing:
        print(f"error: stage(s) {','.join(missing)} not yet ported in "
              "sfm_tpu_torch", file=sys.stderr)
        return 2
    for opt in ("checkpoint_dir", "mesh_devices", "profile_dir", "plot",
                "debug"):
        if getattr(args, opt):
            print(f"error: --{opt} not yet ported in sfm_tpu_torch",
                  file=sys.stderr)
            return 2
    config = config_from_args(args)
    os.makedirs(args.out_dir, exist_ok=True)

    from sfm_tpu_torch.io import load_images, read_pars
    from sfm_tpu_torch.sfm import structure_from_motion
    from sfm_tpu_torch.utils.metrics import StageTimer

    timers = StageTimer()
    calib = read_pars(config.par_path)
    images, _ = load_images(
        config.image_path, config.image_type, config.max_images
    )
    if calib.num_views > images.shape[0]:
        calib = calib.subset(range(images.shape[0]))
    print(f"loaded {images.shape[0]} images {images.shape[1]}x{images.shape[2]}")

    summary = {}
    with timers.stage("sfm"):
        recon = structure_from_motion(images, calib, config)
    mean_reproj = recon.mean_reprojection_error()
    print(f"sparse: {recon.num_tracks} tracks, "
          f"{recon.num_observations} observations, "
          f"mean reproj {mean_reproj:.3f}px")
    recon.export_ply(os.path.join(args.out_dir, "sparse_points.ply"))
    summary["sparse_tracks"] = recon.num_tracks
    summary["sparse_mean_reproj_px"] = mean_reproj
    summary["timers_s"] = {k: round(v, 3) for k, v in timers.times.items()}
    print(json.dumps(summary))
    print("stage timers:")
    print(timers.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
