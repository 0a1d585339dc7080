#!/usr/bin/env python3
"""Quality parity of the PyTorch/CUDA port against the reference.

Counterpart of ``quality.py``: the same criteria, computed through
``sfm_tpu_torch`` on the same datasets and configurations, written as a
JSON of the same shape (``backend``, ``generated``, ``git_rev``,
``reference``, ``ours``, ``criteria``, ``all_pass``).  The reference side
is the one ``quality.py`` reads: ``quality_data/reference_measured.json``
and the clouds and captured BA problem under ``quality_data/ref/``.

  1. reproj_vs_calibration: post-BA rms of the final world points against
     the calibrated cameras, <= 1.05x the reference's.
  2. ba_solver_parity: the port's LM solver on the reference's exact
     captured BA problem, <= 1.05x the reference's rms, after the 12-param
     camera model reproduces the reference's rms at its own solution.
  3. dino48_on_surface_accuracy: median distance of the matched-budget
     dense cloud to the BA-refined sparse anchor, <= 1.05x the reference
     cloud's.
  4. dino8 / dino48 completeness: median reference -> ours distance
     <= 1.5 % of the reference cloud's bounding-box diagonal.
  5. dino8 / dino48 photo-consistency: the PMVS acceptance rule's pass
     rate, >= the reference cloud's; dino48_seed_envelope: at least the
     reference's seeds.

Every criterion but 2 needs the dinoRing images (``--data DIR``, a
directory of the 48 PNGs and ``dinoR_par.txt``; no default).  Without
``--data`` each such criterion is recorded as ``{"skipped": "dataset absent"}``, counts as
neither pass nor fail, and is named in ``skipped``; ``all_pass`` runs over
the criteria that ran.

Usage (on a machine with an NVIDIA GPU; ``--device cpu`` on the host):

    python3 quality_torch.py [--device cuda] [--data DIR] [--out PATH]

Writes ``build/quality_torch/QUALITY.json`` (or ``--out``) and the dense
clouds under ``build/quality_torch/ours/``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
OUT_DIR = os.path.join(ROOT, "build", "quality_torch")
SKIPPED = {"skipped": "dataset absent"}
DINO_CRITERIA = ("reproj_vs_calibration", "dino8_photo_consistency",
                 "dino8_completeness", "dino48_on_surface_accuracy",
                 "dino48_photo_consistency", "dino48_completeness",
                 "dino48_seed_envelope")


def _load_ref():
    with open(os.path.join(ROOT, "quality_data", "reference_measured.json")) as f:
        return json.load(f)


def _ref_cloud(tag):
    z = np.load(os.path.join(ROOT, "quality_data", "ref", tag + ".npz"))
    return z["points"], int(z["full_count"])


def _save_ours(out_dir, tag, points, colors=None):
    """A subsample of at most 50,000 points of a cloud, as ``quality.py``
    saves its own, under ``out_dir/ours``."""
    ours = os.path.join(out_dir, "ours")
    os.makedirs(ours, exist_ok=True)
    rng = np.random.default_rng(0)
    n = points.shape[0]
    sel = rng.choice(n, 50000, replace=False) if n > 50000 else np.arange(n)
    np.savez_compressed(
        os.path.join(ours, tag + ".npz"),
        points=points[sel].astype(np.float32),
        full_count=np.int64(n),
        **({"colors": colors[sel]} if colors is not None else {}),
    )


def nn_dist(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Distance from each point of a to its nearest neighbor in b."""
    from scipy.spatial import cKDTree

    return cKDTree(b).query(a, k=1, workers=-1)[0]


def _stats(d: np.ndarray) -> dict:
    return {
        "mean": float(d.mean()),
        "p10": float(np.percentile(d, 10)),
        "p25": float(np.percentile(d, 25)),
        "median": float(np.median(d)),
        "p75": float(np.percentile(d, 75)),
        "p90": float(np.percentile(d, 90)),
    }


def photo_pass_stats(points, images, calib, device, min_ncc=0.7, bound=3,
                     max_eval=50000) -> dict:
    """Fraction of cloud points passing a multi-view photo-consistency test
    (NCC >= min_ncc against the nearest camera's patch, in >= bound other
    views, each view sampled at its own projection): PMVS's acceptance rule
    applied alike to both clouds, through ``mvs.photoconsistency`` with
    wid 5 and every view scored."""
    import torch

    from sfm_tpu_torch.io.images import device_gray
    from sfm_tpu_torch.mvs.photoconsistency import photo_consistency

    rng = np.random.default_rng(0)
    if points.shape[0] > max_eval:
        points = points[rng.choice(points.shape[0], max_eval, replace=False)]
    centers = calib.centers  # (N, 3)
    d = np.linalg.norm(points[:, None, :] - centers[None, :, :], axis=-1)
    ref_img = np.argmin(d, axis=1).astype(np.int32)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    gray = device_gray(images, device)
    _, _, score, cnt = photo_consistency(
        gray, f32(calib.K), f32(calib.R), f32(calib.t), f32(points),
        torch.as_tensor(ref_img, device=device), min_ncc, wid=5, max_views=0,
    )
    cnt = cnt.cpu().numpy()
    score = score.cpu().numpy()
    return {
        "pass_rate": float((cnt >= bound).mean()),
        "mean_visible_views": float(cnt.mean()),
        "mean_ncc_of_passing": float(score[cnt >= bound].mean())
        if (cnt >= bound).any() else 0.0,
        "evaluated": int(points.shape[0]),
    }


def _dino(data, n_frames=None):
    from sfm_tpu_torch.io import load_images, read_pars

    calib = read_pars(os.path.join(data, "dinoR_par.txt"))
    images, _ = load_images(data, "png", max_images=n_frames)
    return images, calib.subset(range(images.shape[0]))


def ba_solver_parity(ref_rms: float, device) -> dict:
    """The port's LM solver (f32, joint) on the reference's exact captured
    BA problem, as ``quality.py:_ba_solver_parity``."""
    import torch

    from sfm_tpu_torch.ba.model import total_cost
    from sfm_tpu_torch.ba.problem import BAProblem
    from sfm_tpu_torch.ba.solver import solve_lm

    z = np.load(os.path.join(ROOT, "quality_data", "ref",
                             "dino48_ba_problem.npz"))
    n_cams, n_pts = int(z["n_cams"]), int(z["n_pts"])

    def unpack(x):
        """Reference 11-param [rvec3, t3, f, k1, k2, px, py] -> the 12-param
        [rvec3, t3, fx, fy, k1, k2, px, py] with fx = fy = f."""
        c11 = x[: n_cams * 11].reshape(n_cams, 11)
        cams = np.concatenate(
            [c11[:, 0:6], c11[:, 6:7], c11[:, 6:7], c11[:, 7:11]], axis=1
        )
        return cams, x[n_cams * 11:].reshape(n_pts, 3)

    cams0, pts0 = unpack(z["x0"])
    camsf, ptsf = unpack(z["x_final"])
    mask = np.ones(z["cam_idx"].shape[0], bool)
    prob = BAProblem.from_numpy(cams0, pts0, z["cam_idx"], z["pt_idx"],
                                z["pts2d"], mask, dtype=torch.float32,
                                device=device)
    n_obs = prob.num_observations

    def rms_of(cost):
        return float(np.sqrt(2.0 * float(cost) / n_obs))

    # Our residual model at the reference's solution must reproduce its
    # final rms: the 12-param model embeds the 11-param one exactly.
    def f32(a):
        return torch.as_tensor(a, dtype=torch.float32, device=device)

    model_check_rms = rms_of(total_cost(
        f32(camsf), f32(ptsf), prob.cam_idx, prob.point_idx, prob.obs_2d,
        prob.mask))
    _, _, cost, iters = solve_lm(prob, max_iterations=100, ftol=1e-6,
                                 optimize_cameras=True)
    ours_rms = rms_of(cost)
    return {
        "model_check_rms_at_ref_solution": model_check_rms,
        "reference_rms": ref_rms,
        "ours_rms": ours_rms,
        "iterations": int(iters),
        "n_obs": n_obs,
        "ratio": ours_rms / ref_rms,
        "threshold": 1.05,
        "pass": ours_rms <= 1.05 * ref_rms
        and abs(model_check_rms - ref_rms) < 0.02,
    }


def dino8_evaluation(images8, calib8, ref_points, ref_count, device,
                     out_dir=None):
    """The 8-frame pipeline (SfM, points-only BA, MVS at 512 rounds and
    1M patches) and the two dino8 criteria against a reference cloud
    (``ref_points``, of ``ref_count`` points in full), as
    ``quality.py:dino8_evaluation``.  With ``out_dir`` the dense cloud is
    saved under it.  Returns (details dict, criteria dict)."""
    from sfm_tpu_torch.ba import bundle_adjust
    from sfm_tpu_torch.config import BaConfig, MvsConfig, PipelineConfig, RuntimeConfig
    from sfm_tpu_torch.mvs import dense_reconstruction
    from sfm_tpu_torch.sfm import structure_from_motion

    t0 = time.perf_counter()
    recon8 = structure_from_motion(
        images8, calib8, PipelineConfig(runtime=RuntimeConfig(device=str(device))))
    recon8, _ = bundle_adjust(recon8, BaConfig(), device=device)
    dense8 = dense_reconstruction(
        images8, calib8, recon8,
        MvsConfig(max_rounds=512, max_patches=1_000_000), scale=10.0,
        device=device,
    )
    wall8 = time.perf_counter() - t0
    if out_dir:
        _save_ours(out_dir, "dino8_full_all_patches", dense8.points, dense8.colors)
    anchor8 = recon8.world.astype(np.float32)
    diag8 = float(np.linalg.norm(ref_points.max(0) - ref_points.min(0)))
    surf8_ours = _stats(nn_dist(dense8.points, anchor8))
    surf8_ref = _stats(nn_dist(ref_points, anchor8))
    compl8 = _stats(nn_dist(ref_points, dense8.points))
    extra8 = _stats(nn_dist(dense8.points, ref_points))
    details = {
        "n_tracks": recon8.num_tracks,
        "seeds": dense8.num_seeds,
        "dense_points": dense8.num_points,
        "reference_dense_points": ref_count,
        "rounds": dense8.metrics.values["mvs_rounds"],
        "wall_s": round(wall8, 2),
        "dist_to_sparse_anchor_ours": surf8_ours,
        "dist_to_sparse_anchor_ref": surf8_ref,
        "ref_to_ours": compl8,
        "ours_to_ref (coverage, not a criterion)": extra8,
        "ref_bbox_diag": diag8,
    }
    pc8_ours = photo_pass_stats(dense8.points, images8, calib8, device)
    pc8_ref = photo_pass_stats(ref_points, images8, calib8, device)
    details["photo_consistency_ours"] = pc8_ours
    details["photo_consistency_ref"] = pc8_ref
    criteria = {
        "dino8_photo_consistency": {
            "ours_pass_rate": pc8_ours["pass_rate"],
            "reference_pass_rate": pc8_ref["pass_rate"],
            "pass": pc8_ours["pass_rate"] >= pc8_ref["pass_rate"],
        },
        "dino8_completeness": {
            "ref_to_ours_median": compl8["median"],
            "threshold": 0.015 * diag8,
            "pass": compl8["median"] <= 0.015 * diag8,
        },
    }
    return details, criteria


def dino48_evaluation(images, calib, ref, result, device, out_dir):
    """``quality.py``'s dinoRing-48 criteria (1, 3-5 of its docstring) into
    ``result["ours"]`` and ``result["criteria"]``.  As there, both BA
    solves refine the one reconstruction in place, so the joint solve
    starts from the points-only one and the matched-budget MVS runs on the
    joint solve's points."""
    from sfm_tpu_torch.ba import bundle_adjust
    from sfm_tpu_torch.config import BaConfig, MvsConfig, PipelineConfig, RuntimeConfig
    from sfm_tpu_torch.mvs import dense_reconstruction
    from sfm_tpu_torch.sfm import structure_from_motion

    ra = ref["dino48_sparse"]
    t0 = time.perf_counter()
    recon = structure_from_motion(
        images, calib, PipelineConfig(runtime=RuntimeConfig(device=str(device))))
    frozen, _ = bundle_adjust(recon, BaConfig(refine_cameras=False), device=device)
    rms_vs_calib = float(frozen.rms_reprojection_error())
    _, joint_info = bundle_adjust(recon, BaConfig(refine_cameras=True), device=device)
    result["ours"]["dino48_sparse"] = {
        "n_tracks": frozen.num_tracks,
        "n_obs": int(frozen.num_observations),
        "post_ba_rms_vs_calibration_px": rms_vs_calib,
        "post_ba_rms_internal_px": joint_info["rms_reproj_refined_px"],
        "note": "internal rms is over OUR tracks (2.6x more observations "
                "than the reference kept) — solver parity on identical "
                "problems is the ba_solver_parity criterion",
        "wall_s": round(time.perf_counter() - t0, 2),
    }
    result["criteria"]["reproj_vs_calibration"] = {
        "ours_px": rms_vs_calib,
        "reference_px": ra["post_ba_rms_px"],
        "ratio": rms_vs_calib / ra["post_ba_rms_px"],
        "threshold": 1.05,
        "pass": rms_vs_calib <= 1.05 * ra["post_ba_rms_px"],
    }

    refc_pts, refc_count = _ref_cloud("dino48_mvs5k_all_patches")
    t0 = time.perf_counter()
    densec = dense_reconstruction(
        images, calib, frozen, MvsConfig(max_patches=refc_count), scale=10.0,
        device=device,
    )
    wallc = time.perf_counter() - t0
    _save_ours(out_dir, "dino48_matched_all_patches", densec.points, densec.colors)
    anchorc = frozen.world.astype(np.float32)
    diagc = float(np.linalg.norm(refc_pts.max(0) - refc_pts.min(0)))
    surfc_ours = _stats(nn_dist(densec.points, anchorc))
    surfc_ref = _stats(nn_dist(refc_pts, anchorc))
    complc = _stats(nn_dist(refc_pts, densec.points))
    extrac = _stats(nn_dist(densec.points, refc_pts))
    ours = result["ours"]["dino48_matched_budget"] = {
        "dense_points": densec.num_points,
        "target_points": refc_count,
        "seeds": densec.num_seeds,
        "wall_s": round(wallc, 2),
        "dist_to_sparse_anchor_ours": surfc_ours,
        "dist_to_sparse_anchor_ref": surfc_ref,
        "ref_to_ours": complc,
        "ours_to_ref (coverage, not a criterion)": extrac,
        "ref_bbox_diag": diagc,
    }
    crit = result["criteria"]
    crit["dino48_on_surface_accuracy"] = {
        "ours_median": surfc_ours["median"],
        "reference_median": surfc_ref["median"],
        "ratio": surfc_ours["median"] / surfc_ref["median"],
        "threshold": 1.05,
        "pass": surfc_ours["median"] <= 1.05 * surfc_ref["median"],
    }
    pcc_ours = photo_pass_stats(densec.points, images, calib, device)
    pcc_ref = photo_pass_stats(refc_pts, images, calib, device)
    ours["photo_consistency_ours"] = pcc_ours
    ours["photo_consistency_ref"] = pcc_ref
    crit["dino48_photo_consistency"] = {
        "ours_pass_rate": pcc_ours["pass_rate"],
        "reference_pass_rate": pcc_ref["pass_rate"],
        "pass": pcc_ours["pass_rate"] >= pcc_ref["pass_rate"],
    }
    crit["dino48_completeness"] = {
        "ref_to_ours_median": complc["median"],
        "threshold": 0.015 * diagc,
        "pass": complc["median"] <= 0.015 * diagc,
    }
    crit["dino48_seed_envelope"] = {
        "ours": densec.num_seeds,
        "reference": ref["dino48_mvs_5k_iters"]["seeds"],
        "pass": densec.num_seeds >= ref["dino48_mvs_5k_iters"]["seeds"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data", default=None,
                    help="the dinoRing dataset (48 PNGs and dinoR_par.txt); "
                         "without it the criteria that need it are skipped")
    ap.add_argument("--out", default=os.path.join(OUT_DIR, "QUALITY.json"))
    args = ap.parse_args(argv)
    if args.data is not None and not os.path.isfile(
            os.path.join(args.data, "dinoR_par.txt")):
        ap.error(f"--data {args.data}: no dinoR_par.txt there")
    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("error: no CUDA device (use --device cpu to run on the host)",
              file=sys.stderr)
        return 1
    out_dir = os.path.dirname(os.path.abspath(args.out))
    os.makedirs(out_dir, exist_ok=True)
    ref = _load_ref()
    try:
        rev = subprocess.run(
            ["git", "-C", ROOT, "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10,
        ).stdout.strip() or "unknown"
    except (OSError, subprocess.SubprocessError):
        rev = "unknown"
    result = {"backend": device.type,
              "device": (torch.cuda.get_device_name(device)
                         if device.type == "cuda" else "cpu"),
              "generated": time.strftime("%Y-%m-%d %H:%M:%S UTC", time.gmtime()),
              "git_rev": rev,
              "reference": ref,
              "ours": {}, "criteria": {}}

    result["criteria"]["ba_solver_parity"] = ba_solver_parity(
        ref["dino48_sparse"]["internal_rms_px"], device)
    if args.data is not None:
        images, calib = _dino(args.data)
        dino48_evaluation(images, calib, ref, result, device, out_dir)
        images8, calib8 = _dino(args.data, 8)
        ref8_pts, ref8_count = _ref_cloud("dino8_full_all_patches")
        details8, criteria8 = dino8_evaluation(
            images8, calib8, ref8_pts, ref8_count, device, out_dir)
        result["ours"]["dino8_full"] = details8
        result["criteria"].update(criteria8)
    else:
        for name in DINO_CRITERIA:
            result["criteria"][name] = dict(SKIPPED)

    ran = {k: c for k, c in result["criteria"].items() if "skipped" not in c}
    result["skipped"] = sorted(set(result["criteria"]) - set(ran))
    result["all_pass"] = all(c["pass"] for c in ran.values())
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    for name, c in result["criteria"].items():
        verdict = "SKIP" if name not in ran else ("PASS" if c["pass"] else "FAIL")
        print(f"{verdict}  {name}: "
              + json.dumps({k: v for k, v in c.items() if k != "pass"}))
    print(json.dumps({"all_pass": result["all_pass"],
                      "skipped": result["skipped"], "out": args.out}))
    return 0 if result["all_pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
