"""Levenberg-Marquardt bundle adjustment, points-only.

Counterpart of ``sfm_tpu/ba/solver.py`` with ``optimize_cameras=False``
(the default of ``bundle_adjust``): with cameras frozen the normal
equations decouple into one 3x3 block per point, V_p dp = b_p, so each LM
step is a batched closed-form 3x3 solve.  The JAX package's
``lax.while_loop`` is a host loop here; accept/reject, damping and the stop
rules are the same expressions.

V and b_p are sums over each point's observations.  ``segment_sum`` would
become ``index_add_``, whose float atomics on CUDA sum in a different order
on every run; instead each point's observations are gathered into a
(T, L) slot table (L = the longest track) and summed along L, a fixed
order on every device and run.

Joint BA (``optimize_cameras=True``: the reduced camera system by PCG or a
dense Schur solve) is not ported yet (ROADMAP queue 1 item 10) and raises.
"""

from __future__ import annotations

import torch

from sfm_tpu_torch.ba.model import jacobian_blocks, total_cost
from sfm_tpu_torch.ba.problem import BAProblem
from sfm_tpu_torch.geometry.linalg3 import inv3

_JOINT_BA = ("joint BA (optimize_cameras / refine_cameras) is not ported "
             "to sfm_tpu_torch yet (ROADMAP queue 1 item 10)")


def _point_segments(problem: BAProblem) -> torch.Tensor:
    """(T, L) int64 table: row p lists point p's unmasked observations in
    observation order; empty slots hold O, the index of a zero row the
    caller appends.  Built once per solve (one host sync for L)."""
    pid = problem.point_idx.long()
    n_obs = pid.shape[0]
    n_pts = problem.points.shape[0]
    key = torch.where(problem.mask, pid, torch.full_like(pid, n_pts))
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n_pts + 1)[:n_pts]
    n_valid = int(counts.sum())
    width = max(int(counts.max()) if n_pts else 0, 1)
    starts = torch.cumsum(counts, 0) - counts
    order = order[:n_valid]
    seg = key[order]
    slot = torch.arange(n_valid, device=pid.device) - starts[seg]
    table = torch.full((n_pts, width), n_obs, dtype=torch.long, device=pid.device)
    table[seg, slot] = order
    return table


def _segment_sum(values, table):
    """Sum (O, ...) rows into (T, ...) by the slot table (fixed order)."""
    pad = torch.zeros_like(values[:1])
    return torch.cat([values, pad])[table].sum(dim=1)


def _assemble(problem: BAProblem, cams, points, table):
    """The point blocks of the normal equations: V (T, 3, 3) = sum Jp^T Jp
    and b_p (T, 3) = -sum Jp^T r over each point's observations.  (The
    JAX package's camera blocks U, W, b_c feed only the joint solve.)"""
    _, Jp, r = jacobian_blocks(
        cams, points, problem.cam_idx, problem.point_idx, problem.obs_2d,
        problem.mask,
    )
    VtV = torch.einsum("oki,okj->oij", Jp, Jp)
    V = _segment_sum(VtV, table)
    b_p = -_segment_sum(torch.einsum("oki,ok->oi", Jp, r), table)
    return V, b_p


def _damp_diag(M, lam, eps=1e-8):
    """Marquardt damping: M + diag(lam*diag(M) + eps)."""
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    return M + torch.diag_embed(lam * d + eps)


def solve_lm(
    problem: BAProblem,
    max_iterations: int = 50,
    ftol: float = 1e-4,
    init_lambda: float = 1e-3,
    lambda_up: float = 4.0,
    lambda_down: float = 0.5,
    optimize_cameras: bool = True,
):
    """Run LM; returns (cams, points, final_cost 0-dim tensor, iterations
    int).  The loop of ``sfm_tpu.ba.solver._lm_impl``, with one host sync
    per iteration (the stop test).

    Same defaults as ``sfm_tpu.ba.solver.solve_lm``; only
    ``optimize_cameras=False`` (cameras frozen in the solve) is ported, the
    joint solve raises NotImplementedError.
    """
    if optimize_cameras:
        raise NotImplementedError(_JOINT_BA)

    def cost_of(points):
        return total_cost(
            problem.cams, points, problem.cam_idx, problem.point_idx,
            problem.obs_2d, problem.mask,
        )

    table = _point_segments(problem)
    cams, points = problem.cams, problem.points
    lam = torch.tensor(init_lambda, dtype=cams.dtype, device=cams.device)
    cost = cost_of(points)
    iteration = 0
    done = False
    while not done and iteration < max_iterations:
        V, b_p = _assemble(problem, cams, points, table)
        Vinv = inv3(_damp_diag(V, lam))
        new_points = points + torch.einsum("pij,pj->pi", Vinv, b_p)
        new_cost = cost_of(new_points)
        accept = new_cost < cost
        rel_decrease = (cost - new_cost) / torch.clamp_min(cost, 1e-30)
        # The lambda test reads the damping this step used, as in sfm_tpu.
        stop = (accept & (rel_decrease < ftol)) | (lam > 1e8)
        points = torch.where(accept, new_points, points)
        lam = torch.where(accept, lam * lambda_down, lam * lambda_up)
        cost = torch.where(accept, new_cost, cost)
        iteration += 1
        done = bool(stop)
    return cams, points, cost, iteration
