"""High-level bundle-adjustment entry point.

Counterpart of ``sfm_tpu/ba/run.py``: assemble the problem from tracks,
solve with cameras frozen (``refine_cameras=False``, the default: the
reference's output contract keeps cameras at calibration), write the
refined world points back into the reconstruction.  The same ``info`` keys
and ``recon.metrics`` records as the JAX package.  Its ``defer_fetch`` /
``finalize`` and packed-solution fetch hide a remote-TPU link's latency and
have no counterpart here (ROADMAP "Not to port").
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_tpu_torch.ba.problem import build_problem
from sfm_tpu_torch.ba.solver import _JOINT_BA, solve_lm
from sfm_tpu_torch.config import BaConfig, RuntimeConfig
from sfm_tpu_torch.sfm.pipeline import SparseReconstruction
from sfm_tpu_torch.utils.metrics import StageTimer


def bundle_adjust(
    recon: SparseReconstruction,
    config: BaConfig = BaConfig(),
    mesh=None,
    device=RuntimeConfig.device,
):
    """Refine a SparseReconstruction in place on ``device``; returns
    (recon, info dict).

    ``refine_cameras=True`` (joint BA) and ``mesh`` (sharded BA) are not
    ported yet and raise NotImplementedError.
    """
    if config.refine_cameras:
        raise NotImplementedError(_JOINT_BA)
    if mesh is not None:
        raise NotImplementedError(
            "sharded BA (mesh) is not ported to sfm_tpu_torch yet "
            "(ROADMAP queue 1 item 14)"
        )
    timers = StageTimer()
    dtype = torch.float64 if config.dtype == "float64" else torch.float32
    device = torch.device(device)
    with timers.stage("assemble"):
        problem = build_problem(
            recon.calib, recon.world, recon.track_offsets, recon.track_obs,
            dtype=dtype, device=device,
        )
    with timers.stage("solve"):
        _, points, cost, iters = solve_lm(
            problem,
            max_iterations=config.max_iterations,
            ftol=config.ftol,
            init_lambda=config.init_lambda,
            lambda_up=config.lambda_up,
            lambda_down=config.lambda_down,
            optimize_cameras=False,
        )
        points = points.cpu().numpy()
        final_cost = float(cost)
    n_obs = problem.num_observations
    recon.world = points[: recon.num_tracks].astype(np.float64)
    info = {
        "num_observations": n_obs,
        "num_points": recon.num_tracks,
        "num_cameras": recon.calib.num_views,
        "refined_cameras": False,
        "camera_solver": "frozen",
        "timers": timers.times,
        "final_cost": final_cost,
        "iterations": int(iters),
        # cost = 0.5 * sum r^2 over 2 * n_obs components; with frozen
        # cameras this is also the rms against the stored calibration.
        "rms_reproj_refined_px": float(
            np.sqrt(2.0 * final_cost / max(n_obs, 1))
        ),
    }
    recon.metrics.record("ba_final_cost", info["final_cost"])
    recon.metrics.record("ba_iterations", info["iterations"])
    recon.metrics.record("ba_rms_reproj_after_px", info["rms_reproj_refined_px"])
    return recon, info
