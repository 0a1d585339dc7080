"""Levenberg-Marquardt bundle adjustment with a Schur complement.

Counterpart of ``sfm_tpu/ba/solver.py``.  Block normal equations from exact
per-observation Jacobians (``ba/model.py``): U (camera 12x12 blocks), V
(point 3x3 blocks), W (per-observation 12x3 coupling).  With cameras frozen
(``optimize_cameras=False``, the default of ``bundle_adjust``) the system
decouples into one 3x3 block per point, V_p dp = b_p.  The joint solve
eliminates the points and solves the reduced camera system
S = U_l - sum_p W_p V_lp^-1 W_p^T either matrix-free by block-Jacobi
preconditioned conjugate gradients (``_pcg``: each S x is three segment
passes over the observations; the residual is tested on the device and
read by the host once a block of iterations; on one CUDA device the block
is a CUDA graph, ``_GraphPCG``) or, for small camera counts, by dense
assembly and a Cholesky factorisation (``_dense_schur_dc``), then
back-substitutes the points.  The JAX package's ``lax.while_loop``s are host
loops here; accept/reject, damping and the stop rules are the same
expressions.

Every sum over observations runs in a fixed order: ``segment_sum`` would
become ``index_add_``, whose float atomics on CUDA sum in a different order
on every run, and these sums feed the accept comparison.  Instead each
point's (camera's) observations are gathered into a slot table (one row per
segment, as wide as the longest) and summed along it.

Over a mesh (``parallel.DataMesh``) the observations are split over the
shards and the partial sums added in shard order (``solve_lm(mesh=)``); a
solve without a mesh is the same loop on a mesh of one device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from sfm_tpu_torch.ba.model import jacobian_blocks, total_cost
from sfm_tpu_torch.ba.problem import BAProblem
from sfm_tpu_torch.geometry.linalg3 import inv3
from sfm_tpu_torch.parallel.mesh import DataMesh, graphable
from sfm_tpu_torch.utils.metrics import span

_OBS_FIELDS = ("cam_idx", "point_idx", "obs_2d", "mask")


def _segments(idx: torch.Tensor, mask: torch.Tensor, n_seg: int) -> torch.Tensor:
    """(n_seg, L) int64 slot table: row s lists the unmasked entries with
    ``idx == s`` in their order; empty slots hold O = ``idx.shape[0]``, the
    index of a zero row the caller appends.  Built once per solve (one host
    sync for L)."""
    idx = idx.long()
    n = idx.shape[0]
    key = torch.where(mask, idx, torch.full_like(idx, n_seg))
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=n_seg + 1)[:n_seg]
    n_valid = int(counts.sum())
    width = max(int(counts.max()) if n_seg else 0, 1)
    starts = torch.cumsum(counts, 0) - counts
    order = order[:n_valid]
    seg = key[order]
    slot = torch.arange(n_valid, device=idx.device) - starts[seg]
    table = torch.full((n_seg, width), n, dtype=torch.long, device=idx.device)
    table[seg, slot] = order
    return table


def _point_segments(problem: BAProblem) -> torch.Tensor:
    """The (T, L) table of each point's observations."""
    return _segments(problem.point_idx, problem.mask, problem.points.shape[0])


def _camera_segments(problem: BAProblem) -> torch.Tensor:
    """The (N, L) table of each camera's observations."""
    return _segments(problem.cam_idx, problem.mask, problem.cams.shape[0])


def _segment_sum(values, table):
    """Sum (O, ...) rows into (S, ...) by the slot table (fixed order)."""
    pad = torch.zeros_like(values[:1])
    return torch.cat([values, pad])[table].sum(dim=1)


class _Tables(NamedTuple):
    """A shard's fixed-order summation structure, built once per solve."""

    point: torch.Tensor                 # (T, L) slot table
    cam: torch.Tensor = None            # (N, Lc) slot table (joint solve)
    pairs: tuple = None                 # dense solve: see _pair_structure


class _Blocks(NamedTuple):
    V: torch.Tensor                     # (T, 3, 3), summed over the mesh
    b_p: torch.Tensor                   # (T, 3)
    U: torch.Tensor = None              # (N, 12, 12)
    b_c: torch.Tensor = None            # (N, 12)
    W: tuple = ()                       # per shard (O_s, 12, 3)


def _assemble_shard(problem: BAProblem, cams, points, tables, joint: bool):
    """One shard's partial blocks: V (T, 3, 3) = sum Jp^T Jp and b_p (T, 3)
    = -sum Jp^T r over each point's observations and, for the joint solve,
    U (N, 12, 12) = sum Jc^T Jc, b_c (N, 12) = -sum Jc^T r over each
    camera's, with the per-observation coupling W = Jc^T Jp."""
    Jc, Jp, r = jacobian_blocks(
        cams, points, problem.cam_idx, problem.point_idx, problem.obs_2d,
        problem.mask,
    )
    V = _segment_sum(torch.einsum("oki,okj->oij", Jp, Jp), tables.point)
    b_p = -_segment_sum(torch.einsum("oki,ok->oi", Jp, r), tables.point)
    if not joint:
        return V, b_p
    U = _segment_sum(torch.einsum("oki,okj->oij", Jc, Jc), tables.cam)
    b_c = -_segment_sum(torch.einsum("oki,ok->oi", Jc, r), tables.cam)
    W = torch.einsum("oki,okj->oij", Jc, Jp)
    return V, b_p, U, b_c, W


def _assemble(mesh, shards, cams_r, points_r, tables, joint: bool) -> _Blocks:
    """The normal-equation blocks, each shard's partials summed with
    ``mesh.psum`` in shard order (W stays per shard)."""
    parts = [_assemble_shard(sp, c, p, tab, joint)
             for sp, c, p, tab in zip(shards, cams_r, points_r, tables)]
    summed = [mesh.psum([part[i] for part in parts]) for i in range(4 if joint else 2)]
    W = tuple(part[4] for part in parts) if joint else ()
    return _Blocks(*summed, W=W)


def _damp_diag(M, lam, eps=1e-8):
    """Marquardt damping: M + diag(lam*diag(M) + eps)."""
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    return M + torch.diag_embed(lam * d + eps)


def _to_cameras(mesh, shards, tables, W, per_point):
    """sum over observations of W_o v[point(o)] into cameras: (N, 12).
    ``per_point`` is a (T, 3) tensor on the lead device."""
    vs = mesh.replicate(per_point)
    return mesh.psum([
        _segment_sum(torch.einsum("oij,oj->oi", w, v[sp.point_idx.long()]),
                     tab.cam)
        for sp, tab, w, v in zip(shards, tables, W, vs)
    ])


def _to_points(mesh, shards, tables, W, per_cam):
    """sum over observations of W_o^T x[camera(o)] into points: (T, 3).
    ``per_cam`` is an (N, 12) tensor on the lead device."""
    xs = mesh.replicate(per_cam)
    return mesh.psum([
        _segment_sum(torch.einsum("oij,oi->oj", w, x[sp.cam_idx.long()]),
                     tab.point)
        for sp, tab, w, x in zip(shards, tables, W, xs)
    ])


def _schur_matvec(x, mesh, shards, tables, blocks, U_lam, Vinv):
    """S x for the reduced camera system, matrix-free over observations:
    S = U_l - sum_p W_p V_lp^-1 W_p^T, three segment passes (over a mesh:
    two psums)."""
    Ux = torch.einsum("nij,nj->ni", U_lam, x)
    a_p = _to_points(mesh, shards, tables, blocks.W, x)           # (T, 3)
    b_vp = torch.einsum("pij,pj->pi", Vinv, a_p)
    return Ux - _to_cameras(mesh, shards, tables, blocks.W, b_vp)


# CG iterations between two host reads of the stop flag.
CG_BLOCK = 10


class _CGState(NamedTuple):
    """One PCG solve's state on its device, updated in place: the iterate,
    residual and direction (N, 12), rz = r . z, the stop threshold
    tol * |b|, whether the next iteration runs, and the iterations run."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    rz: torch.Tensor
    thresh: torch.Tensor
    active: torch.Tensor
    count: torch.Tensor

    @classmethod
    def like(cls, b):
        return cls(torch.zeros_like(b), torch.zeros_like(b),
                   torch.zeros_like(b), b.new_zeros(()), b.new_zeros(()),
                   torch.zeros((), dtype=torch.bool, device=b.device),
                   torch.zeros((), dtype=torch.long, device=b.device))


def _precondition(Minv_blocks, r):
    return torch.einsum("nij,nj->ni", Minv_blocks, r)


def _cg_more(s: _CGState, iters: int):
    """The stop rule of ``sfm_tpu.ba.solver._pcg`` on the device: another
    iteration runs while fewer than ``iters`` have run and
    |r| > tol * |b|."""
    return (s.count < iters) & (torch.sqrt(torch.sum(s.r * s.r)) > s.thresh)


def _cg_start(s: _CGState, b, Minv_blocks, iters: int, tol: float):
    """Reset ``s`` to the start of a solve of S x = b."""
    s.x.zero_()
    s.r.copy_(b)
    z = _precondition(Minv_blocks, b)
    s.p.copy_(z)
    s.rz.copy_(torch.sum(b * z))
    s.thresh.copy_(tol * (torch.sqrt(torch.sum(b * b)) + 1e-30))
    s.count.zero_()
    s.active.copy_(_cg_more(s, iters))


def _cg_step(s: _CGState, matvec, Minv_blocks, iters: int):
    """One CG iteration where ``s.active``: the new values go through
    ``torch.where``, so a stopped solve keeps its state bit for bit
    whatever a later step computes.  No host sync."""
    Ap = matvec(s.p)
    alpha = s.rz / torch.clamp_min(torch.sum(s.p * Ap), 1e-30)
    x = s.x + alpha * s.p
    r = s.r - alpha * Ap
    z = _precondition(Minv_blocks, r)
    rz = torch.sum(r * z)
    beta = rz / torch.clamp_min(s.rz, 1e-30)
    p = z + beta * s.p
    go = s.active
    for old, new in ((s.x, x), (s.r, r), (s.p, p), (s.rz, rz)):
        torch.where(go, new, old, out=old)
    s.count.add_(go)
    torch.logical_and(go, _cg_more(s, iters), out=s.active)


def _cg_block(s: _CGState, matvec, Minv_blocks, iters: int):
    for _ in range(CG_BLOCK):
        _cg_step(s, matvec, Minv_blocks, iters)


def _pcg_blocks(s: _CGState, b, Minv_blocks, iters: int, tol: float,
                run_block):
    """Block-Jacobi preconditioned CG for the (N, 12) camera system: the
    loop of ``sfm_tpu.ba.solver._pcg`` with the same stopping rule, tested
    on the device (``_cg_step``).  ``run_block()`` runs ``CG_BLOCK``
    iterations on ``s``; the host reads the stop flag after each block
    (the span ``wait`` under the caller's open span).  Returns (x,
    iterations run)."""
    _cg_start(s, b, Minv_blocks, iters, tol)
    for _ in range(-(-iters // CG_BLOCK)):
        run_block()
        with span("wait"):  # the host blocks on the device here
            if not bool(s.active):
                break
    return s.x.clone(), int(s.count)


def _pcg(matvec, b, Minv_blocks, iters: int, tol: float):
    """``_pcg_blocks`` run eagerly on a fresh state."""
    s = _CGState.like(b)
    return _pcg_blocks(s, b, Minv_blocks, iters, tol,
                       lambda: _cg_block(s, matvec, Minv_blocks, iters))


class _GraphPCG:
    """``_pcg`` as a CUDA graph of ``CG_BLOCK`` iterations, captured once
    per ``solve_lm`` call (the slot tables and every operand's shape are
    fixed within one) over static copies of the operands.  Each solve
    copies its W, U_lam, V_lam^-1 and preconditioner in, resets the state
    and replays the graph block by block: the same kernels in the same
    order as the eager loop, launched by the device."""

    def __init__(self, mesh, shards, tables, blocks, U_lam, Vinv,
                 Minv_blocks, b, iters: int):
        (W,) = blocks.W
        self.operands = (W.clone(), U_lam.clone(), Vinv.clone(),
                         Minv_blocks.clone())
        W_s, U_s, Vinv_s, Minv_s = self.operands
        static = blocks._replace(W=(W_s,))
        self.iters = iters
        self.state = s = _CGState.like(b)

        def matvec(x):
            return _schur_matvec(x, mesh, shards, tables, static, U_s, Vinv_s)

        # Capture runs on a side stream, after one eager iteration there
        # that makes the library handles and workspaces; its values are
        # scratch: every solve starts the state afresh.
        current = torch.cuda.current_stream(b.device)
        side = torch.cuda.Stream(b.device)
        side.wait_stream(current)
        with torch.cuda.stream(side):
            _cg_start(s, b, Minv_s, iters, 0.0)
            _cg_step(s, matvec, Minv_s, iters)
            self.graph = torch.cuda.CUDAGraph()
            self.graph.capture_begin(capture_error_mode="thread_local")
            _cg_block(s, matvec, Minv_s, iters)
            self.graph.capture_end()
        current.wait_stream(side)

    def solve(self, blocks, U_lam, Vinv, Minv_blocks, b, tol: float):
        for dst, src in zip(self.operands, (blocks.W[0], U_lam, Vinv,
                                            Minv_blocks)):
            dst.copy_(src)
        return _pcg_blocks(self.state, b, Minv_blocks, self.iters, tol,
                           self.graph.replay)


def _pair_structure(problem: BAProblem, point_table: torch.Tensor):
    """Same-point observation pairs of one shard, for the dense assembly
    of S: every ordered pair (o_i, o_j) of observations of one point,
    sorted (stably) by the camera block (cam(o_i), cam(o_j)) it adds to.

    Returns (oi, oj, pt (P,) indices; lengths (B,) pairs per block;
    bi, bj (B,) the blocks' camera indices).  O(observations x track
    length) entries; built once per solve.
    """
    n_obs = problem.cam_idx.shape[0]
    n_cams = problem.cams.shape[0]
    live = point_table < n_obs                                   # (T, L)
    pt, i, j = torch.nonzero(live[:, :, None] & live[:, None, :], as_tuple=True)
    oi, oj = point_table[pt, i], point_table[pt, j]
    cam = problem.cam_idx.long()
    key = cam[oi] * n_cams + cam[oj]
    order = torch.argsort(key, stable=True)
    blocks, lengths = torch.unique_consecutive(key[order], return_counts=True)
    return (oi[order], oj[order], pt[order], lengths,
            blocks // n_cams, blocks % n_cams)


# Bytes per same-point pair while the dense assembly runs: the int64 index
# lists of ``_pair_structure`` (nonzero's rows, oi, oj, the camera key and
# its sort order) and, per LM iteration, the gathered operands and products
# of ``_dense_schur_dc``'s einsum in floats: W_oi and W_oj (36 each),
# V_lp^-1 (9), W_oi V_lp^-1 (36) and the 12 x 12 block (144).
_PAIR_INDEX_BYTES = 80
_PAIR_FLOATS = 261


def pair_assembly_bytes(track_lengths, n_points: int, itemsize: int):
    """(P, bytes) of the dense assembly on one device: P = sum of squared
    track lengths (the same-point pairs), and the bytes of the (T, L, L)
    bool mask (T the padded point count, L the longest track) plus P pairs
    of index lists and float blocks at ``itemsize`` bytes a float."""
    lengths = np.asarray(track_lengths, np.int64)
    pairs = int((lengths * lengths).sum())
    longest = int(lengths.max()) if lengths.size else 0
    return pairs, (n_points * longest * longest
                   + pairs * (_PAIR_INDEX_BYTES + _PAIR_FLOATS * itemsize))


def _dense_schur_dc(mesh, shards, tables, blocks, U_lam, Vinv, g):
    """Solve the reduced camera system S dc = g by dense assembly and a
    Cholesky factorisation.

    S = U_l - sum_p W_p V_lp^-1 W_p^T is assembled over same-point
    observation pairs (``_pair_structure``): pair (o_i, o_j) of point p adds
    W_oi V_lp^-1 W_oj^T to block (cam(o_i), cam(o_j)).  The pairs are
    sorted by block and summed per block in that fixed order
    (``torch.segment_reduce``: one thread walks a segment), O(observations
    x track length) in time and memory.  (The JAX package scatters W into
    (T, Nc, 12, 3) grids and contracts the point axis with one matrix
    product, O(points x cameras); that layout is not carried over.)  Over a
    mesh each shard must hold every observation of its points
    (``ba.sharded.shard_problem(track_aligned=True)``), so its pairs are
    local and the per-shard partial S's psum into the exact S.

    Jacobi scaling keeps the factorisation conditioned; cameras with no
    observations have ~eps diagonals from the damping and scale to identity
    rows.  A failed factorisation (S not positive definite under extreme
    rounding) gives a NaN step, which LM rejects and answers with more
    damping, as NaNs do in the JAX package.
    """
    n_cams = U_lam.shape[0]
    parts = []
    for tab, w, vinv in zip(tables, blocks.W, mesh.replicate(Vinv)):
        oi, oj, pt, lengths, bi, bj = tab.pairs
        pair = torch.einsum("kab,kbc,kdc->kad", w[oi], vinv[pt], w[oj])
        summed = torch.segment_reduce(
            pair.reshape(-1, 144), "sum", lengths=lengths, unsafe=True
        )
        S4 = pair.new_zeros((n_cams, 12, n_cams, 12))
        S4[bi, :, bj, :] = -summed.reshape(-1, 12, 12)
        parts.append(S4)
    S4 = mesh.psum(parts)
    ii = torch.arange(n_cams, device=S4.device)
    S4[ii, :, ii, :] += U_lam
    S2 = S4.reshape(12 * n_cams, 12 * n_cams)
    dsc = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(S2), 1e-12))
    L, info = torch.linalg.cholesky_ex(S2 * dsc[:, None] * dsc[None, :])
    y = torch.cholesky_solve((g.reshape(-1) * dsc)[:, None], L)[:, 0]
    dc = (y * dsc).reshape(n_cams, 12)
    return torch.where(info == 0, dc, torch.full_like(dc, float("nan")))


def solve_lm(
    problem: BAProblem,
    max_iterations: int = 50,
    ftol: float = 1e-4,
    init_lambda: float = 1e-3,
    lambda_up: float = 4.0,
    lambda_down: float = 0.5,
    optimize_cameras: bool = True,
    cg_iters: int = 100,
    cg_tol: float = 1e-6,
    pair_span: int = 0,
    mesh=None,
):
    """Run LM; returns (cams, points, final_cost 0-dim tensor, iterations
    int).  The loop of ``sfm_tpu.ba.solver._lm_impl``, with one host sync
    per iteration (accept and the stop test together, the span ``wait``
    under the caller's open span: ``ba.solve.wait``).  The PCG camera solve
    is the span ``cg`` (``ba.solve.cg``) and adds one sync per
    ``CG_BLOCK`` CG iterations (``ba.solve.cg.wait``); it counts into
    ``solve_lm.cg_solves``, ``solve_lm.cg_iterations``,
    ``solve_lm.cg_capped`` (solves that ran all ``cg_iters`` iterations)
    and ``solve_lm.cg_graph_solves`` (solves by CUDA graph replay: on a
    mesh of one CUDA shard, ``parallel.mesh.graphable``: ``_GraphPCG``;
    eager elsewhere).

    ``optimize_cameras=False`` freezes the cameras in the solve itself (no
    reduced system at all).  ``pair_span > 0`` selects the dense reduced
    camera system (``_dense_schur_dc``) over matrix-free PCG; as in
    ``sfm_tpu`` only its sign is read.

    ``mesh`` (a ``parallel.DataMesh`` whose lead device holds ``problem``;
    by default a mesh of that one device) splits the observations evenly
    over its shards: each shard sums its partial blocks and cost over its
    own observations on its own device, with its own fixed-order slot
    tables; ``mesh.psum`` adds the partials in shard order (where
    ``sfm_tpu`` has ``psum``); the solves and accept/reject run once on the
    lead device, and the new parameters go back to the shards.  The dense
    solve needs shards cut at track boundaries
    (``ba.sharded.solve_lm_sharded`` does that).

    Same defaults as ``sfm_tpu.ba.solver.solve_lm``.
    """
    cams, points = problem.cams, problem.points
    joint = bool(optimize_cameras)
    dense = joint and pair_span > 0
    mesh = mesh or DataMesh([points.device])
    # Pad rows of the split are index 0 with mask False: inert.
    obs = [mesh.split(getattr(problem, f)) for f in _OBS_FIELDS]
    shards = [
        BAProblem(cams=c, points=p, cam_idx=ci, point_idx=pi, obs_2d=o2,
                  mask=mk)
        for c, p, ci, pi, o2, mk in zip(
            mesh.replicate(cams), mesh.replicate(points), *obs)
    ]
    tables = []
    for sp in shards:
        point = _point_segments(sp)
        tables.append(_Tables(
            point=point,
            cam=_camera_segments(sp) if joint else None,
            pairs=_pair_structure(sp, point) if dense else None,
        ))

    def cost_of(cams_r, points_r):
        return mesh.psum([
            total_cost(c, p, sp.cam_idx, sp.point_idx, sp.obs_2d, sp.mask)
            for sp, c, p in zip(shards, cams_r, points_r)
        ])

    cams_r, points_r = mesh.replicate(cams), mesh.replicate(points)
    lam = torch.tensor(init_lambda, dtype=cams.dtype, device=cams.device)
    cost = cost_of(cams_r, points_r)
    graph = None  # the PCG solve's _GraphPCG, made at its first solve
    iteration = 0
    done = False
    while not done and iteration < max_iterations:
        blocks = _assemble(mesh, shards, cams_r, points_r, tables, joint)
        Vinv = inv3(_damp_diag(blocks.V, lam))
        if joint:
            U_lam = _damp_diag(blocks.U, lam)
            # Schur right-hand side: g = b_c - W V^-1 b_p.
            vb = torch.einsum("pij,pj->pi", Vinv, blocks.b_p)
            g = blocks.b_c - _to_cameras(mesh, shards, tables, blocks.W, vb)
            if dense:
                dc = _dense_schur_dc(mesh, shards, tables, blocks, U_lam,
                                     Vinv, g)
            else:
                with span("cg"):
                    Minv = torch.linalg.inv(U_lam)
                    if not graphable(mesh):
                        dc, cg_its = _pcg(
                            lambda x: _schur_matvec(x, mesh, shards, tables,
                                                    blocks, U_lam, Vinv),
                            g, Minv, cg_iters, cg_tol,
                        )
                    else:
                        if graph is None:
                            graph = _GraphPCG(mesh, shards, tables, blocks,
                                              U_lam, Vinv, Minv, g, cg_iters)
                        dc, cg_its = graph.solve(blocks, U_lam, Vinv, Minv,
                                                 g, cg_tol)
                        solve_lm.cg_graph_solves += 1
                solve_lm.cg_solves += 1
                solve_lm.cg_iterations += cg_its
                solve_lm.cg_capped += cg_its == cg_iters
            # Back-substitute the points: dp = V^-1 (b_p - W^T dc).
            wtd = _to_points(mesh, shards, tables, blocks.W, dc)
            dp = torch.einsum("pij,pj->pi", Vinv, blocks.b_p - wtd)
            new_cams = cams + dc
        else:
            dp = torch.einsum("pij,pj->pi", Vinv, blocks.b_p)
            new_cams = cams
        new_points = points + dp
        new_cr = mesh.replicate(new_cams) if joint else cams_r
        new_pr = mesh.replicate(new_points)
        new_cost = cost_of(new_cr, new_pr)
        accept = new_cost < cost
        rel_decrease = (cost - new_cost) / torch.clamp_min(cost, 1e-30)
        # The lambda test reads the damping this step used, as in sfm_tpu.
        stop = (accept & (rel_decrease < ftol)) | (lam > 1e8)
        lam = torch.where(accept, lam * lambda_down, lam * lambda_up)
        cost = torch.where(accept, new_cost, cost)
        iteration += 1
        with span("wait"):  # the host blocks on the device here
            accepted, done = torch.stack([accept, stop]).tolist()
        if accepted:
            cams, cams_r = new_cams, new_cr
            points, points_r = new_points, new_pr
    return cams, points, cost, iteration


# Process counters of the PCG camera solves (one a joint LM iteration off
# the dense path): solves, CG iterations, solves stopped at cg_iters, and
# solves by CUDA graph replay.
solve_lm.cg_solves = 0
solve_lm.cg_iterations = 0
solve_lm.cg_capped = 0
solve_lm.cg_graph_solves = 0
