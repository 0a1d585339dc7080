"""Bundle adjustment at scale: 256 cameras, 100,000 points and 1,000,000
observations.

Counterpart of ``tools/ba_scale.py``: the same synthetic problem
(``synth_problem``: the same numpy draws in the same order, projections in
float32) and the same four solves of the LM solver's camera paths:

  - ``frozen_1M``: points only (the pipeline's default) at 1M observations;
  - ``joint_pcg_1M``: cameras and points, the reduced camera system by
    matrix-free PCG;
  - ``joint_pcg_256c_200k`` and ``joint_dense_256c_200k``: the same solve
    by PCG and by the dense reduced system on a 256-camera, 8,192-point,
    200,000-observation slice (seed 1; no larger than ``--points`` and
    ``--obs``), and how far their costs differ.

The dense solve is called directly, as the JAX tool does; the line before
it says what ``ba.run.dense_gate`` would choose for that problem.
``--equality`` instead solves the 1M problem jointly on a mesh of 8
virtual shards of the run's device and on the device alone, and compares.

Run on a machine with an NVIDIA GPU (``--device cpu`` on the host; keep the
sizes small there):

    python3 -m sfm_tpu_torch.tools.ba_scale [--cams 256] [--points 100000]
        [--obs 1000000] [--iters 20] [--reps 3] [--device cuda] [--equality]

One JSON line per solve (``timed_solve``'s keys), then the agreement line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from sfm_tpu_torch.ba.problem import BAProblem
from sfm_tpu_torch.ba.run import dense_gate_counts
from sfm_tpu_torch.ba.sharded import solve_lm_sharded
from sfm_tpu_torch.ba.solver import solve_lm
from sfm_tpu_torch.config import BaConfig
from sfm_tpu_torch.geometry.projection import project_cam
from sfm_tpu_torch.parallel import DataMesh

# The dense-versus-PCG slice: 8,192 points and 200,000 observations of
# the same camera ring, drawn with seed 1 (no larger than the main problem).
SLICE_POINTS, SLICE_OBS, SLICE_SEED = 8_192, 200_000, 1
AGREE_REL = 5e-3
EQUAL_REL = 1e-4
SHARDS = 8


def synth_problem(n_cams, n_pts, n_obs, dtype=torch.float32, seed=0,
                  noise_px=0.5, point_jitter=0.02, device="cpu") -> BAProblem:
    """A ring of cameras around a ball of points; every observation is a
    real projection plus noise, so the optimum is near the ground truth.
    The draws of ``tools/ba_scale.py:synth_problem`` in its order; the
    projections in float32 on ``device``, as the JAX tool projects with
    64-bit mode off."""
    rng = np.random.default_rng(seed)
    ang = np.linspace(0, 2 * np.pi, n_cams, endpoint=False)
    # 12-parameter cameras [rvec(3), t(3), fx, fy, k1, k2, px, py] on a ring
    # at r = 3 looking inward (rvec about y), t = (0, 0, 3) in each frame.
    rvec = np.stack([np.zeros(n_cams), ang, np.zeros(n_cams)], 1)
    t = np.tile(np.asarray([0.0, 0.0, 3.0]), (n_cams, 1))
    cams = np.concatenate(
        [
            rvec, t,
            np.full((n_cams, 2), 800.0) + rng.normal(size=(n_cams, 2)) * 5,
            np.zeros((n_cams, 2)),
            np.full((n_cams, 2), 320.0),
        ],
        axis=1,
    )
    pts = rng.normal(size=(n_pts, 3)) * 0.4
    cam_idx = rng.integers(0, n_cams, n_obs)
    point_idx = rng.integers(0, n_pts, n_obs)
    f32 = lambda a: torch.as_tensor(a, dtype=torch.float32, device=device)  # noqa: E731
    proj = project_cam(f32(pts[point_idx]), f32(cams[cam_idx])).cpu().numpy()
    obs = proj + rng.normal(size=(n_obs, 2)) * noise_px
    pts_init = pts + rng.normal(size=pts.shape) * point_jitter
    fl = lambda a: torch.as_tensor(a, dtype=dtype, device=device)  # noqa: E731
    return BAProblem(
        cams=fl(cams), points=fl(pts_init),
        cam_idx=torch.as_tensor(cam_idx, dtype=torch.int32, device=device),
        point_idx=torch.as_tensor(point_idx, dtype=torch.int32, device=device),
        obs_2d=fl(obs),
        mask=torch.ones(n_obs, dtype=torch.bool, device=device),
    )


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_solve(problem, label, reps=3, emit=print, mesh=None, **kw):
    """One cold solve, then ``reps`` more, each ending in a host read of
    the cost; one JSON line.  ``peak_device_bytes`` is the largest
    allocation over them (None on the host)."""
    device = problem.points.device
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    solve = (lambda: solve_lm_sharded(problem, mesh, **kw)) if mesh else (
        lambda: solve_lm(problem, **kw))
    _sync(device)
    t0 = time.perf_counter()
    cams, pts, cost, iters = solve()
    cost = float(cost)
    cold = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        cams, pts, cost, iters = solve()
        cost = float(cost)
        walls.append(time.perf_counter() - t0)
    it = int(iters)
    n_obs = int(problem.mask.shape[0])
    wall = sorted(walls)[len(walls) // 2] if walls else cold
    rec = {
        "label": label,
        "cold_s": round(cold, 4),
        "wall_s": round(wall, 4),
        "walls": [round(w, 4) for w in walls],
        "iterations": it,
        "s_per_iter": round(wall / max(it, 1), 5),
        "obs_per_s": round(n_obs * it / wall, 0),
        "final_cost": cost,
        "rms_px": round(float(np.sqrt(2.0 * cost / max(n_obs, 1))), 4),
        "peak_device_bytes": (torch.cuda.max_memory_allocated(device)
                              if on_card else None),
    }
    emit(json.dumps(rec))
    return rec, (cams, pts)


def dense_gate_of(problem: BAProblem, config=BaConfig(refine_cameras=True)):
    """``ba.run.dense_gate``'s decision for ``problem`` (its tracks: each
    point's observations)."""
    pi = problem.point_idx[problem.mask].long().cpu()
    lengths = torch.bincount(pi, minlength=problem.points.shape[0]).numpy()
    return dense_gate_counts(lengths, problem.cams.shape[0], config)


def labelled_solves(prob, small, iters=20, reps=3, emit=print):
    """The JAX tool's four solves, keyword for keyword; returns
    (records by label, dense gate of ``small``, agreement record)."""
    recs = {}
    for label, p, kw in (
            ("frozen_1M", prob, dict(optimize_cameras=False)),
            ("joint_pcg_1M", prob, dict(optimize_cameras=True, pair_span=0)),
            ("joint_pcg_256c_200k", small, dict(optimize_cameras=True,
                                                pair_span=0))):
        recs[label] = timed_solve(p, label, reps, emit, max_iterations=iters,
                                  **kw)[0]
    gate = dense_gate_of(small)
    emit(json.dumps({"dense_gate_256c_200k": gate}))
    recs["joint_dense_256c_200k"] = timed_solve(
        small, "joint_dense_256c_200k", reps, emit, max_iterations=iters,
        optimize_cameras=True, pair_span=1)[0]
    pcg, dense = recs["joint_pcg_256c_200k"], recs["joint_dense_256c_200k"]
    rel = abs(pcg["final_cost"] - dense["final_cost"]) / max(pcg["final_cost"], 1e-30)
    agree = {"dense_vs_pcg_rel_dcost": rel, "agree": bool(rel < AGREE_REL)}
    emit(json.dumps(agree))
    return recs, gate, agree


def equality(prob, iters=20, shards=SHARDS, emit=print):
    """The joint (PCG) solve of ``prob`` on a mesh of ``shards`` virtual
    shards of its device against the device alone: iterations, largest
    parameter differences and the relative cost difference; ``pass`` when
    that is below 1e-4 with equal iterations."""
    device = prob.points.device
    kw = dict(max_iterations=iters, optimize_cameras=True)
    one, (c1, p1) = timed_solve(prob, "single", 0, lambda s: None, **kw)
    many, (c2, p2) = timed_solve(prob, f"sharded{shards}", 0, lambda s: None,
                                 mesh=DataMesh([device] * shards), **kw)
    rel = abs(one["final_cost"] - many["final_cost"]) / max(one["final_cost"], 1e-30)
    rec = {
        "device": str(device), "shards": shards,
        "single_s": one["cold_s"], f"sharded{shards}_s": many["cold_s"],
        "iters": [one["iterations"], many["iterations"]],
        "max_abs_dcams": float((c1 - c2).abs().max()),
        "max_abs_dpoints": float((p1 - p2).abs().max()),
        "rel_dcost": rel,
        "pass": bool(rel < EQUAL_REL and one["iterations"] == many["iterations"]),
    }
    emit(json.dumps({"equality": rec}))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cams", type=int, default=256)
    ap.add_argument("--points", type=int, default=100_000)
    ap.add_argument("--obs", type=int, default=1_000_000)
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--equality", action="store_true",
                    help=f"solve on {SHARDS} virtual shards of the device "
                         "and on the device alone, and compare (instead of "
                         "the four solves)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            print("error: no CUDA device (use --device cpu to solve on the "
                  "host)", file=sys.stderr)
            return 1
        print(f"device: {torch.cuda.get_device_name(device)}", flush=True)
    else:
        print(f"device: {device}", flush=True)
    prob = synth_problem(args.cams, args.points, args.obs, device=device)
    print(json.dumps({"problem": {
        "cams": args.cams, "points": args.points, "obs": args.obs,
        "params": 12 * args.cams + 3 * args.points,
        "residuals": 2 * args.obs}}), flush=True)
    emit = lambda s: print(s, flush=True)  # noqa: E731
    if args.equality:
        return 0 if equality(prob, args.iters, emit=emit)["pass"] else 1
    small = synth_problem(args.cams, min(SLICE_POINTS, args.points),
                          min(SLICE_OBS, args.obs), seed=SLICE_SEED,
                          device=device)
    _, _, agree = labelled_solves(prob, small, args.iters, args.reps, emit)
    return 0 if agree["agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
