"""High-level bundle-adjustment entry point.

Counterpart of ``sfm_tpu/ba/run.py``: assemble the problem from tracks,
solve, write the refined world points back into the reconstruction.  With
``refine_cameras=False`` (the default: the reference's output contract
keeps cameras at calibration) the cameras are frozen in the solve itself;
``refine_cameras=True`` runs the joint solve, its reduced camera system by a
dense Cholesky solve up to ``dense_schur_max_cams`` cameras and by PCG above.
The same ``info`` keys and ``recon.metrics`` records as the JAX package.
Its ``defer_fetch`` / ``finalize`` and packed-solution fetch hide a
remote-TPU link's latency and have no counterpart here (ROADMAP "Not to
port").
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from sfm_tpu_torch.ba.problem import build_problem
from sfm_tpu_torch.ba.sharded import solve_lm_sharded
from sfm_tpu_torch.ba.solver import solve_lm
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

    With ``mesh`` (a ``parallel.DataMesh``) the observations are split over
    its shards (``ba.sharded.solve_lm_sharded``) and the solve runs on
    ``mesh.lead`` (``device`` is not read).  With ``refine_cameras`` the
    refined cameras come back as ``info["cams11"]`` ((N, 12) camera
    vectors, the JAX package's key); ``recon.calib`` stays the calibration,
    and ``ba_rms_reproj_after_px`` is then measured against it.
    """
    timers = StageTimer()
    dtype = torch.float64 if config.dtype == "float64" else torch.float32
    device = mesh.lead if mesh is not None else torch.device(device)
    with timers.stage("assemble"):
        problem = build_problem(
            recon.calib, recon.world, recon.track_offsets, recon.track_obs,
            dtype=dtype, device=device,
        )
    if config.dense_schur_max_span != BaConfig().dense_schur_max_span:
        warnings.warn(
            "BaConfig.dense_schur_max_span is deprecated and has no effect "
            "(the dense-Schur assembly does not depend on track length); "
            "use dense_schur_max_cams to steer the solver choice",
            DeprecationWarning,
            stacklevel=2,
        )
    # Dense-Schur eligibility (joint mode only): S is (12 * Nc)^2, so gate
    # on the camera count.  ``dense_schur_max_bytes`` bounded the JAX
    # package's (T, Nc, 12, 3) scatter grids; the assembly here runs over
    # same-point observation pairs and has no such grids, so the field
    # stays for config parity and nothing reads it.
    pair_span = int(
        config.refine_cameras
        and recon.num_tracks > 0
        and recon.calib.num_views <= config.dense_schur_max_cams
    )
    with timers.stage("solve"):
        solve = dict(
            max_iterations=config.max_iterations,
            ftol=config.ftol,
            init_lambda=config.init_lambda,
            lambda_up=config.lambda_up,
            lambda_down=config.lambda_down,
            optimize_cameras=config.refine_cameras,
            pair_span=pair_span,
        )
        if mesh is not None:
            cams, points, cost, iters = solve_lm_sharded(problem, mesh, **solve)
        else:
            cams, points, cost, iters = solve_lm(problem, **solve)
        points = points.cpu().numpy()
        final_cost = float(cost)
    n_obs = problem.num_observations
    recon.world = points[: recon.num_tracks].astype(np.float64)
    info = {
        "num_observations": n_obs,
        "num_points": recon.num_tracks,
        "num_cameras": recon.calib.num_views,
        "refined_cameras": bool(config.refine_cameras),
        "camera_solver": (
            "dense_schur" if pair_span
            else ("pcg" if config.refine_cameras else "frozen")
        ),
        "timers": timers.times,
        "final_cost": final_cost,
        "iterations": int(iters),
        # The optimum's own rms, against the REFINED parameter set
        # (cost = 0.5 * sum r^2 over 2 * n_obs components).
        "rms_reproj_refined_px": float(
            np.sqrt(2.0 * final_cost / max(n_obs, 1))
        ),
    }
    if config.refine_cameras:
        # Without the problem's padded camera rows.
        info["cams11"] = cams[: recon.calib.num_views].cpu().numpy()
    recon.metrics.record("ba_final_cost", info["final_cost"])
    recon.metrics.record("ba_iterations", info["iterations"])
    # With frozen cameras the refined-parameter rms IS the rms against the
    # stored calibration; the joint solve's cameras differ from it, so
    # there it is computed against the calibration.
    recon.metrics.record(
        "ba_rms_reproj_after_px",
        info["rms_reproj_refined_px"] if not config.refine_cameras
        else recon.rms_reprojection_error(),
    )
    if mesh is not None:
        recon.metrics.record("ba_mesh_devices", mesh.size)
    return recon, info
