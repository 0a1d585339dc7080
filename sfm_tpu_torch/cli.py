"""Command-line entry point, counterpart of ``sfm_tpu/cli.py``.

Takes the same flags (plus ``--device``) and runs the same stages: ``sfm``
writes ``sparse_points.ply``, ``ba`` (points-only bundle adjustment)
``sparse_points_ba.ply``, ``mvs`` ``initial_patches.ply`` and
``all_patches.ply``, and the summary JSON has the same keys.
``--refine_cameras`` runs joint bundle adjustment, ``--enable_outlier_filter``
the MVS outlier filter, and ``--checkpoint_dir`` saves each stage's output
there (``sfm.npz``, ``ba.npz``: the JAX package's files, readable by either
package) plus the mid-MVS state every ``--mvs_checkpoint_every`` rounds, so
``--stages ba,mvs`` or ``--stages mvs`` resume from them.
``--mesh_devices N`` (N > 1) runs every stage over one mesh of up to N
devices of ``--device``'s kind (``run_mesh``); N <= 1 is a plain
single-device run, as in ``sfm_tpu``.  ``--nonSequence`` matches all
C(n, 2) image pairs.  ``--plot`` writes ``sparse_before_ba.png``,
``sparse_after_ba.png`` and ``dense.png``, ``--debug`` the epipolar lines
of the first three pairs (``debug_epipolar_{a}_{b}.png``); both need
matplotlib (without it they exit 1).  ``--profile_dir DIR`` records the
run with torch.profiler (host activity, and the GPU's on CUDA) and writes
it as a Chrome trace, ``DIR/trace.json``, in which the program's spans
(``utils/metrics.py``: ``sfm``, ``ba``, ``mvs`` here, the reconstruction's
``features.gray`` ... ``mvs.expand.wait`` below them) are host ranges.

Run: ``python -m sfm_tpu_torch.cli -img_p DIR -par_p DIR/x_par.txt -t png
[--stages sfm,ba,mvs] [--device cuda] [--mesh_devices N]``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

STAGES = ("sfm", "ba", "mvs")
TRACE_FILE = "trace.json"


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
                   help="epipolar debug overlays (needs matplotlib)")
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
                   help="comma list from {sfm,ba,mvs}")
    p.add_argument("--out_dir", default=".")
    p.add_argument("--checkpoint_dir", default=None)
    p.add_argument("--mvs_checkpoint_every", type=int, default=16)
    p.add_argument("--mesh_devices", type=int, default=None)
    p.add_argument("--plot", action="store_true",
                   help="3-D scatter PNGs of the clouds (needs matplotlib)")
    p.add_argument("--profile_dir", default=None,
                   help="write a torch.profiler Chrome trace of the run here")
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


def run_mesh(config):
    """The mesh the stages run over: None unless ``mesh_shape`` > 1 (as
    ``sfm_tpu/cli.py``), else up to ``mesh_shape`` devices of the run's
    device kind -- for CUDA the visible GPUs from ``--device``'s index on
    (``cuda`` starts at 0), for the CPU its one device.

    In a process of a ``torch.distributed`` group (``main`` called after
    ``parallel.distributed.initialize_multihost``) the mesh always spans
    the group, one shard a process (on CUDA ``data_mesh()``'s GPU of the
    process); a ``mesh_shape`` > 1 below the group's size raises."""
    import torch
    import torch.distributed as dist

    from sfm_tpu_torch.parallel import data_mesh

    n = config.runtime.mesh_shape
    device = torch.device(config.runtime.device)
    if dist.is_initialized():
        return data_mesh(num_devices=n if n and n > 1 else None,
                         devices=None if device.type == "cuda" else [device])
    if not n or n <= 1:
        return None
    if device.type == "cuda":
        devices = [torch.device("cuda", i) for i in
                   range(device.index or 0, torch.cuda.device_count())]
    else:
        devices = [device]
    return data_mesh(num_devices=n, devices=devices)


@contextlib.contextmanager
def profiled(profile_dir, device):
    """torch.profiler around the body when ``profile_dir`` is set (CPU
    activity, plus CUDA on a CUDA device), exported as a Chrome trace to
    ``profile_dir/TRACE_FILE`` when the body returns.  The profiler can
    lose the first events of a session on a GPU, now and then more than
    ten, so the session opens with 32 marker fills and a sync."""
    if not profile_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    activities = [ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        marker = torch.empty(1024, device=device)
        for _ in range(32):
            marker.fill_(0.0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        yield
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    path = os.path.join(profile_dir, TRACE_FILE)
    prof.export_chrome_trace(path)
    print(f"profiler trace written to {path}")


def main(argv=None) -> int:
    """CLI entry point; bad input and pipeline errors exit 1 with a message,
    an unknown stage exits 2."""
    try:
        return _main(argv)
    except (RuntimeError, FileNotFoundError, ValueError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    stages = [s.strip() for s in args.stages.split(",") if s.strip()]
    unknown = [s for s in stages if s not in STAGES]
    if unknown:
        print(f"error: unknown stage(s) {','.join(unknown)}", file=sys.stderr)
        return 2
    if args.plot or args.debug:
        from sfm_tpu_torch.utils.viz import require_matplotlib

        require_matplotlib()
    config = config_from_args(args)
    mesh = run_mesh(config)
    # Over a group mesh every process runs the stages; process 0 writes.
    lead = mesh is None or mesh.process_index == 0
    if lead:
        os.makedirs(args.out_dir, exist_ok=True)
    with profiled(args.profile_dir if lead else None, config.runtime.device):
        rc = _run_stages(args, stages, config, mesh, lead)
    if mesh is not None:
        mesh.barrier()  # nothing reads process 0's files before they are whole
    return rc


def _run_stages(args, stages, config, mesh, lead) -> int:
    device = config.runtime.device

    from sfm_tpu_torch.io import load_images, read_pars
    from sfm_tpu_torch.io.ply import export_ply
    from sfm_tpu_torch.utils import checkpoint as ckpt
    from sfm_tpu_torch.utils import viz
    from sfm_tpu_torch.utils.metrics import StageTimer

    timers = StageTimer()
    calib = read_pars(config.par_path)
    images, _ = load_images(
        config.image_path, config.image_type, config.max_images
    )
    if calib.num_views > images.shape[0]:
        calib = calib.subset(range(images.shape[0]))
    print(f"loaded {images.shape[0]} images {images.shape[1]}x{images.shape[2]}")

    recon = None
    summary = {}
    if "sfm" in stages:
        recon = ckpt.try_resume(args.checkpoint_dir, "sfm")
        if recon is not None:
            print("resumed sparse reconstruction from checkpoint")
        else:
            from sfm_tpu_torch.sfm import structure_from_motion

            with timers.stage("sfm"):
                recon = structure_from_motion(images, calib, config, mesh=mesh)
            if args.checkpoint_dir and lead:
                ckpt.save_sparse(ckpt.stage_path(args.checkpoint_dir, "sfm"),
                                 recon)
        mean_reproj = recon.mean_reprojection_error()
        print(f"sparse: {recon.num_tracks} tracks, "
              f"{recon.num_observations} observations, "
              f"mean reproj {mean_reproj:.3f}px")
        if lead:
            recon.export_ply(os.path.join(args.out_dir, "sparse_points.ply"))
        summary["sparse_tracks"] = recon.num_tracks
        summary["sparse_mean_reproj_px"] = mean_reproj
        if lead and args.debug and recon.debug_pairs is not None:
            dp = recon.debug_pairs
            for pi in range(min(3, len(dp["pairs"]))):
                a, b = dp["pairs"][pi]
                sel = dp["inlier"][pi]
                viz.draw_epipolar_debug(
                    images[a], images[b],
                    dp["p1"][pi][sel], dp["p2"][pi][sel], dp["F"][pi],
                    path=os.path.join(
                        args.out_dir, f"debug_epipolar_{a}_{b}.png"
                    ),
                )
        if lead and args.plot:
            viz.scatter3d(recon.world, scale=args.scale,
                          title="without bundle adjustment",
                          path=os.path.join(args.out_dir, "sparse_before_ba.png"))

    if "ba" in stages:
        if recon is None:
            recon = ckpt.try_resume(args.checkpoint_dir, "sfm")
            if recon is None:
                print("error: BA requested but no sparse reconstruction",
                      file=sys.stderr)
                return 2
        from sfm_tpu_torch.ba import bundle_adjust

        with timers.stage("ba"):
            recon, info = bundle_adjust(recon, config.ba, mesh=mesh,
                                        device=device)
        ba_rms = recon.rms_reprojection_error()
        print(f"ba: cost {info['final_cost']:.4g} after {info['iterations']} "
              f"iterations; rms reproj {ba_rms:.3f}px")
        if args.checkpoint_dir and lead:
            ckpt.save_sparse(ckpt.stage_path(args.checkpoint_dir, "ba"), recon)
        if lead:
            recon.export_ply(os.path.join(args.out_dir, "sparse_points_ba.ply"))
        summary["ba_final_cost"] = info["final_cost"]
        summary["ba_rms_reproj_px"] = ba_rms
        if lead and args.plot:
            viz.scatter3d(recon.world, scale=args.scale,
                          title="with bundle adjustment",
                          path=os.path.join(args.out_dir, "sparse_after_ba.png"))

    if "mvs" in stages:
        if recon is None:
            recon = (ckpt.try_resume(args.checkpoint_dir, "ba")
                     or ckpt.try_resume(args.checkpoint_dir, "sfm"))
            if recon is None:
                print("error: MVS requested but no reconstruction",
                      file=sys.stderr)
                return 2
        from sfm_tpu_torch.mvs import dense_reconstruction

        with timers.stage("mvs"):
            dense = dense_reconstruction(
                images, recon.calib, recon, config.mvs, scale=args.scale,
                mesh=mesh, checkpoint_dir=args.checkpoint_dir,
                checkpoint_every=args.mvs_checkpoint_every,
                device=device, kernels=config.runtime.kernels,
            )
        if dense.metrics.values.get("mvs_resumed_at_round"):
            print("resumed MVS expansion from round "
                  f"{dense.metrics.values['mvs_resumed_at_round']}")
        print(f"mvs: {dense.num_seeds} seeds -> {dense.num_points} points "
              f"in {dense.metrics.values['mvs_rounds']} rounds")
        if lead:
            export_ply(
                os.path.join(args.out_dir, "initial_patches.ply"),
                dense.points[: dense.num_seeds], dense.colors[: dense.num_seeds],
            )
            dense.export_ply(os.path.join(args.out_dir, "all_patches.ply"))
        summary["mvs_seeds"] = dense.num_seeds
        summary["mvs_points"] = dense.num_points
        if lead and args.plot:
            viz.scatter3d(dense.points, dense.colors, scale=args.scale,
                          title="reconstruct_results",
                          path=os.path.join(args.out_dir, "dense.png"))

    summary["timers_s"] = {k: round(v, 3) for k, v in timers.times.items()}
    print(json.dumps(summary))
    print("stage timers:")
    print(timers.summary())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
