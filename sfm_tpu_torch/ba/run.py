"""High-level bundle-adjustment entry point.

Counterpart of ``sfm_tpu/ba/run.py``: assemble the problem from tracks,
solve, write the refined world points back into the reconstruction.  With
``refine_cameras=False`` (the default: the reference's output contract
keeps cameras at calibration) the cameras are frozen in the solve itself;
``refine_cameras=True`` runs the joint solve, its reduced camera system by a
dense Cholesky solve or by PCG (``dense_gate``).
The same ``info`` keys and ``recon.metrics`` records as the JAX package,
plus the dense gate's counts.  ``defer_fetch`` leaves the solution on the
device until ``info["finalize"]()``, as in the JAX package, so a caller can
enqueue MVS first (MVS re-triangulates its seeds from the observations and
never reads the refined points).
"""

from __future__ import annotations

import warnings

import numpy as np
import torch

from sfm_tpu_torch.ba.problem import _pad_len, build_problem
from sfm_tpu_torch.ba.sharded import solve_lm_sharded
from sfm_tpu_torch.ba.solver import pair_assembly_bytes, solve_lm
from sfm_tpu_torch.config import BaConfig, RuntimeConfig
from sfm_tpu_torch.sfm.pipeline import SparseReconstruction
from sfm_tpu_torch.utils.metrics import StageTimer


def dense_gate(recon: SparseReconstruction, config: BaConfig) -> dict:
    """Whether the joint solve takes the dense reduced camera system, and
    what decided it.

    Dense only while all three hold, in this order: the camera count is at
    most ``dense_schur_max_cams``; the JAX package's own bound,
    4 * T * Nc * 144 bytes of its (T, Nc, 12, 3) scatter grids (unpadded
    counts, ``sfm_tpu/ba/run.py`` letter for letter), is at most
    ``dense_schur_max_bytes``; and this package's assembly over same-point
    pairs (``solver.pair_assembly_bytes``: P = sum of squared track
    lengths, at the BA dtype) fits the same bound.  The first two give
    ``sfm_tpu``'s choice; the third can send a problem with long tracks to
    PCG where ``sfm_tpu`` solves it densely (a deliberate difference: the
    port's assembly grows with P, not with T * Nc).

    Returns ``ba_dense_schur_pairs`` (P), ``ba_dense_schur_pair_bytes``,
    ``ba_dense_schur_grid_bytes`` (the JAX package's count) and
    ``ba_dense_schur_decided_by``: "dense", or the bound that sent the
    problem to PCG ("max_cams", "grid_bytes", "pair_bytes"); "frozen" for
    a points-only solve, "no_tracks" without tracks.
    """
    return dense_gate_counts(recon.track_lengths(), recon.calib.num_views,
                             config)


def dense_gate_counts(track_lengths, n_cams: int, config: BaConfig) -> dict:
    """``dense_gate`` for a problem given by its track lengths (one per
    point, observations of that point) and camera count."""
    n_tracks = len(track_lengths)
    itemsize = 8 if config.dtype == "float64" else 4
    pairs, pair_bytes = pair_assembly_bytes(
        track_lengths, _pad_len(n_tracks, 1024), itemsize)
    grid_bytes = 4 * n_tracks * n_cams * 144
    if not config.refine_cameras:
        decided = "frozen"
    elif not n_tracks:
        decided = "no_tracks"
    elif n_cams > config.dense_schur_max_cams:
        decided = "max_cams"
    elif grid_bytes > config.dense_schur_max_bytes:
        decided = "grid_bytes"
    elif pair_bytes > config.dense_schur_max_bytes:
        decided = "pair_bytes"
    else:
        decided = "dense"
    return {"ba_dense_schur_pairs": pairs,
            "ba_dense_schur_pair_bytes": pair_bytes,
            "ba_dense_schur_grid_bytes": grid_bytes,
            "ba_dense_schur_decided_by": decided}


def bundle_adjust(
    recon: SparseReconstruction,
    config: BaConfig = BaConfig(),
    mesh=None,
    device=RuntimeConfig.device,
    defer_fetch: bool = False,
):
    """Refine a SparseReconstruction in place on ``device``; returns
    (recon, info dict).

    ``defer_fetch=True`` enqueues the solve but leaves its host copies
    (points, cost, iterations, the refined cameras) and the write-back into
    ``recon`` to ``info["finalize"]()``, which must be called before
    ``recon.world`` or the solution's ``info`` keys are read; it is
    idempotent, and the eager default calls it before returning.  The
    solver's LM loop reads its stopping flag every iteration, so little of
    the solve is left to run at the return.

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
            "use dense_schur_max_cams / dense_schur_max_bytes to steer the "
            "solver choice",
            DeprecationWarning,
            stacklevel=2,
        )
    gate = dense_gate(recon, config)
    pair_span = int(gate["ba_dense_schur_decided_by"] == "dense")
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
    n_obs = problem.num_observations
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
    }
    if config.refine_cameras:
        info.update(gate)
        for k, v in gate.items():
            recon.metrics.record(k, v)
    if mesh is not None:
        recon.metrics.record("ba_mesh_devices", mesh.size)

    def finalize():
        """Copy the solution to the host and publish it into ``recon`` and
        ``info`` (idempotent)."""
        if "final_cost" in info:
            return recon, info
        with timers.stage("fetch"):
            world = points.cpu().numpy()
            final_cost = float(cost)
            info["iterations"] = int(iters)
            if config.refine_cameras:
                # Without the problem's padded camera rows.
                info["cams11"] = cams[: recon.calib.num_views].cpu().numpy()
        recon.world = world[: recon.num_tracks].astype(np.float64)
        info["final_cost"] = final_cost
        # The optimum's own rms, against the REFINED parameter set
        # (cost = 0.5 * sum r^2 over 2 * n_obs components).
        info["rms_reproj_refined_px"] = float(
            np.sqrt(2.0 * final_cost / max(n_obs, 1)))
        recon.metrics.record("ba_final_cost", info["final_cost"])
        recon.metrics.record("ba_iterations", info["iterations"])
        # With frozen cameras the refined-parameter rms IS the rms against
        # the stored calibration; the joint solve's cameras differ from it,
        # so there it is computed against the calibration.
        recon.metrics.record(
            "ba_rms_reproj_after_px",
            info["rms_reproj_refined_px"] if not config.refine_cameras
            else recon.rms_reprojection_error(),
        )
        return recon, info

    info["finalize"] = finalize
    if not defer_fetch:
        finalize()
    return recon, info
