"""Plain bundle adjustment of the reference: the padded problem, the
12-parameter camera model with closed-form Jacobian blocks, and
Levenberg-Marquardt with fixed-order sums, points-only or joint (dense
reduced camera system or block-Jacobi PCG, by the program's gate).

A frozen copy of ``sfm_tpu_torch/ba/`` (``problem.py``, ``model.py``,
``solver.py``, ``run.py``) at commit bfc7f14, for one device (no mesh).
Plain PyTorch and NumPy; imports nothing of the program.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from sfmref.geometry import (
    _EPS,
    inv3,
    pack_cam,
    project_cam,
    rodrigues_vector,
    rotate_points,
)


@dataclass
class BAProblem:
    """Padded bundle-adjustment problem, tensors on one device.

    cams: (N, 12) float; points: (T, 3) float;
    cam_idx/point_idx: (O,) int32; obs_2d: (O, 2) float; mask: (O,) bool.
    Padded observations have mask=False and index 0.
    """

    cams: torch.Tensor
    points: torch.Tensor
    cam_idx: torch.Tensor
    point_idx: torch.Tensor
    obs_2d: torch.Tensor
    mask: torch.Tensor


def _pad_len(n: int, multiple: int) -> int:
    return ((max(n, 1) + multiple - 1) // multiple) * multiple


def build_problem(
    K: np.ndarray,
    R: np.ndarray,
    t: np.ndarray,
    world: np.ndarray,
    track_offsets: np.ndarray,
    track_obs: np.ndarray,
    dtype=torch.float32,
    pad_to: int = 1024,
    pad_points_to: int = 1024,
    pad_cams_to: int = 8,
    device="cpu",
) -> BAProblem:
    """Flatten tracks into a padded BAProblem on ``device``.

    Args mirror SparseReconstruction.{world, track_offsets, track_obs}.
    Camera vectors are packed in float64 (pad cameras: identity rotation,
    zero translation) and then cast to ``dtype``.
    """
    n_tracks = world.shape[0]
    n_obs = track_obs.shape[0]
    lengths = np.diff(track_offsets)
    point_idx = np.repeat(np.arange(n_tracks, dtype=np.int64), lengths)
    cam_idx = track_obs[:, 0].astype(np.int64)
    obs_2d = track_obs[:, 1:3].astype(np.float64)

    n_views = K.shape[0]
    K_h, R_h, t_h = K, R, t
    if pad_cams_to > 1:
        c_pad = _pad_len(n_views, pad_cams_to) - n_views
        if c_pad:
            K_h = np.concatenate([K_h, np.tile(np.eye(3), (c_pad, 1, 1))])
            R_h = np.concatenate([R_h, np.tile(np.eye(3), (c_pad, 1, 1))])
            t_h = np.concatenate([t_h, np.zeros((c_pad, 3))])
    K_t, R_t, t_t = (torch.from_numpy(np.asarray(a, np.float64)) for a in (K_h, R_h, t_h))
    cams = pack_cam(K_t, rodrigues_vector(R_t), t_t).numpy()
    points = np.asarray(world, np.float64)
    if pad_points_to > 1:
        t_pad = _pad_len(n_tracks, pad_points_to) - n_tracks
        if t_pad:
            points = np.concatenate([points, np.zeros((t_pad, 3))])

    o_pad = _pad_len(n_obs, pad_to)
    pad = o_pad - n_obs
    mask = np.concatenate([np.ones(n_obs, bool), np.zeros(pad, bool)])
    point_idx = np.concatenate([point_idx, np.zeros(pad, np.int64)])
    cam_idx = np.concatenate([cam_idx, np.zeros(pad, np.int64)])
    obs_2d = np.concatenate([obs_2d, np.zeros((pad, 2))])
    def f(a):
        return torch.tensor(np.asarray(a), dtype=dtype, device=device)

    def i(a):
        return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)

    return BAProblem(cams=f(cams), points=f(points), cam_idx=i(cam_idx),
                     point_idx=i(point_idx), obs_2d=f(obs_2d),
                     mask=torch.tensor(mask, device=device))


def residuals(cams, points, cam_idx, point_idx, obs_2d, mask=None):
    """Per-observation residuals (O, 2); masked rows are zero."""
    r = project_cam(points[point_idx.long()], cams[cam_idx.long()]) - obs_2d
    if mask is not None:
        r = r * mask[:, None].to(r.dtype)
    return r


def total_cost(cams, points, cam_idx, point_idx, obs_2d, mask=None):
    """0.5 * sum of squared residuals (scipy least_squares convention);
    a 0-dim tensor on the inputs' device."""
    r = residuals(cams, points, cam_idx, point_idx, obs_2d, mask)
    return 0.5 * torch.sum(r * r)


def _skew(v):
    """(..., 3) -> (..., 3, 3) cross-product matrix [v]x."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack(
        [torch.stack([o, -z, y], -1), torch.stack([z, o, -x], -1),
         torch.stack([-y, x, o], -1)], -2,
    )


def _rotation_jacobians(w, v):
    """For P = rotate_points(v, w): dP/dv = R(w) and dP/dw, both (..., 3, 3).

    Rodrigues branch: R = cos I + sin [k]x + (1 - cos) k k^T (k = w / theta)
    and dP/dw = -R [v]x (w w^T + (R^T - I) [w]x) / theta^2 (Gallego & Yezzi,
    "A compact formula for the derivative of a 3-D rotation in exponential
    coordinates", 2015).  Taylor branch (theta^2 < 1e-14): R = I + W + W^2/2
    and dP/dw = -[v]x + (w v^T + (w . v) I - 2 v w^T) / 2.
    """
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    theta2 = torch.sum(w * w, dim=-1)[..., None, None]
    small = theta2 < 1e-14
    theta2 = torch.where(small, torch.ones_like(theta2), theta2)
    theta = torch.sqrt(theta2)
    k = w / theta[..., 0]
    cos, sin = torch.cos(theta), torch.sin(theta)
    W, V = _skew(w), _skew(v)
    R_main = cos * eye + sin * _skew(k) + (1.0 - cos) * (k[..., :, None] * k[..., None, :])
    R_taylor = eye + W + 0.5 * (W @ W)
    d_main = -(R_main @ V) @ (
        w[..., :, None] * w[..., None, :] + (R_main.transpose(-1, -2) - eye) @ W
    ) / theta2
    wv = torch.sum(w * v, dim=-1)[..., None, None]
    d_taylor = -V + 0.5 * (
        w[..., :, None] * v[..., None, :] + wv * eye - 2.0 * v[..., :, None] * w[..., None, :]
    )
    return torch.where(small, R_taylor, R_main), torch.where(small, d_taylor, d_main)


def jacobian_blocks(cams, points, cam_idx, point_idx, obs_2d, mask=None):
    """Exact Jacobian blocks per observation.

    Returns (Jc (O, 2, 12), Jp (O, 2, 3), r (O, 2)), all zeroed on masked
    rows so padded observations contribute nothing to any normal equation.
    """
    c = cams[cam_idx.long()]
    p = points[point_idx.long()]
    r = project_cam(p, c) - obs_2d

    w, f = c[:, 0:3], c[:, 6:8]
    k1, k2 = c[:, 8:9], c[:, 9:10]
    P = rotate_points(p, w) + c[:, 3:6]
    z = P[:, 2:3]
    live = z.abs() >= _EPS              # project_cam's guarded z is a constant
    zs = torch.where(live, z, torch.full_like(z, _EPS))
    xy = P[:, :2] / zs
    n = torch.sum(xy * xy, dim=-1, keepdim=True)
    rad = 1.0 + k1 * n + k2 * n * n
    # d(xy)/dP (O, 2, 3)
    inv_z = 1.0 / zs
    zero = torch.zeros_like(inv_z)
    dz = torch.where(live, -xy * inv_z, torch.zeros_like(xy))
    dxy = torch.stack(
        [torch.cat([inv_z, zero, dz[:, 0:1]], -1),
         torch.cat([zero, inv_z, dz[:, 1:2]], -1)], 1,
    )
    # d(xy * rad)/d(xy) = rad I + 2 (k1 + 2 k2 n) xy xy^T, then scale by f.
    eye2 = torch.eye(2, dtype=r.dtype, device=r.device)
    M = rad[..., None] * eye2 + (2.0 * (k1 + 2.0 * k2 * n))[..., None] * (
        xy[:, :, None] * xy[:, None, :]
    )
    A = f[:, :, None] * (M @ dxy)                       # dr/dP (O, 2, 3)
    R, dRv_dw = _rotation_jacobians(w, p)
    Jp = A @ R
    Jc = torch.cat(
        [A @ dRv_dw, A, torch.diag_embed(xy * rad), (xy * n * f)[..., None],
         (xy * n * n * f)[..., None], eye2.expand(r.shape[0], 2, 2)],
        dim=-1,
    )                                   # [rvec | t | fx, fy | k1 | k2 | px, py]
    if mask is not None:
        m = mask.to(r.dtype)
        r = r * m[:, None]
        Jc = Jc * m[:, None, None]
        Jp = Jp * m[:, None, None]
    return Jc, Jp, r


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


def _assemble(problem: BAProblem, cams, points, tables, joint: bool):
    """The normal-equation blocks: V (T, 3, 3) = sum Jp^T Jp and b_p (T, 3)
    = -sum Jp^T r over each point's observations and, for the joint solve,
    U (N, 12, 12) = sum Jc^T Jc, b_c (N, 12) = -sum Jc^T r over each
    camera's, with the per-observation coupling W = Jc^T Jp."""
    Jc, Jp, r = jacobian_blocks(
        cams, points, problem.cam_idx, problem.point_idx, problem.obs_2d,
        problem.mask,
    )
    V = _segment_sum(torch.einsum("oki,okj->oij", Jp, Jp), tables["point"])
    b_p = -_segment_sum(torch.einsum("oki,ok->oi", Jp, r), tables["point"])
    if not joint:
        return {"V": V, "b_p": b_p}
    U = _segment_sum(torch.einsum("oki,okj->oij", Jc, Jc), tables["cam"])
    b_c = -_segment_sum(torch.einsum("oki,ok->oi", Jc, r), tables["cam"])
    W = torch.einsum("oki,okj->oij", Jc, Jp)
    return {"V": V, "b_p": b_p, "U": U, "b_c": b_c, "W": W}


def _damp_diag(M, lam, eps=1e-8):
    """Marquardt damping: M + diag(lam*diag(M) + eps)."""
    d = torch.diagonal(M, dim1=-2, dim2=-1)
    return M + torch.diag_embed(lam * d + eps)


def _to_cameras(problem, tables, W, per_point):
    """sum over observations of W_o v[point(o)] into cameras: (N, 12)."""
    return _segment_sum(
        torch.einsum("oij,oj->oi", W, per_point[problem.point_idx.long()]),
        tables["cam"])


def _to_points(problem, tables, W, per_cam):
    """sum over observations of W_o^T x[camera(o)] into points: (T, 3)."""
    return _segment_sum(
        torch.einsum("oij,oi->oj", W, per_cam[problem.cam_idx.long()]),
        tables["point"])


def _pcg(matvec, b, Minv_blocks, iters: int, tol: float):
    """Block-Jacobi preconditioned CG for the (N, 12) camera system."""

    def apply_prec(r):
        return torch.einsum("nij,nj->ni", Minv_blocks, r)

    x = torch.zeros_like(b)
    r = b
    z = apply_prec(r)
    p = z
    rz = torch.sum(r * z)
    bnorm = torch.sqrt(torch.sum(b * b)) + 1e-30
    it = 0
    while it < iters and bool(torch.sqrt(torch.sum(r * r)) > tol * bnorm):
        Ap = matvec(p)
        alpha = rz / torch.clamp_min(torch.sum(p * Ap), 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        z = apply_prec(r)
        rz_new = torch.sum(r * z)
        beta = rz_new / torch.clamp_min(rz, 1e-30)
        p = z + beta * p
        rz = rz_new
        it += 1
    return x


def _pair_structure(problem: BAProblem, point_table: torch.Tensor):
    """Same-point observation pairs, sorted (stably) by the camera block
    (cam(o_i), cam(o_j)) they add to: (oi, oj, pt, lengths, bi, bj)."""
    n_obs = problem.cam_idx.shape[0]
    n_cams = problem.cams.shape[0]
    live = point_table < n_obs
    pt, i, j = torch.nonzero(live[:, :, None] & live[:, None, :], as_tuple=True)
    oi, oj = point_table[pt, i], point_table[pt, j]
    cam = problem.cam_idx.long()
    key = cam[oi] * n_cams + cam[oj]
    order = torch.argsort(key, stable=True)
    blocks, lengths = torch.unique_consecutive(key[order], return_counts=True)
    return (oi[order], oj[order], pt[order], lengths,
            blocks // n_cams, blocks % n_cams)


# Bytes per same-point pair of the dense assembly (the program's gate).
_PAIR_INDEX_BYTES = 80
_PAIR_FLOATS = 261


def pair_assembly_bytes(track_lengths, n_points: int, itemsize: int):
    """(P, bytes) of the dense assembly: P = sum of squared track lengths."""
    lengths = np.asarray(track_lengths, np.int64)
    pairs = int((lengths * lengths).sum())
    longest = int(lengths.max()) if lengths.size else 0
    return pairs, (n_points * longest * longest
                   + pairs * (_PAIR_INDEX_BYTES + _PAIR_FLOATS * itemsize))


def _dense_schur_dc(tables, blocks, U_lam, Vinv, g):
    """Solve S dc = g, S = U_l - sum_p W_p V_lp^-1 W_p^T assembled over
    same-point pairs in a fixed order, by a Jacobi-scaled Cholesky
    factorisation; a failed factorisation gives a NaN step."""
    n_cams = U_lam.shape[0]
    oi, oj, pt, lengths, bi, bj = tables["pairs"]
    w = blocks["W"]
    pair = torch.einsum("kab,kbc,kdc->kad", w[oi], Vinv[pt], w[oj])
    summed = torch.segment_reduce(
        pair.reshape(-1, 144), "sum", lengths=lengths, unsafe=True
    )
    S4 = pair.new_zeros((n_cams, 12, n_cams, 12))
    S4[bi, :, bj, :] = -summed.reshape(-1, 12, 12)
    ii = torch.arange(n_cams, device=S4.device)
    S4[ii, :, ii, :] += U_lam
    # A bfloat16 solve (the control's) factorises in float32: PyTorch has
    # no bfloat16 Cholesky.
    S2 = S4.reshape(12 * n_cams, 12 * n_cams).to(_SOLVE_DTYPE.get(
        S4.dtype, S4.dtype))
    dsc = 1.0 / torch.sqrt(torch.clamp_min(torch.diagonal(S2), 1e-12))
    L, info = torch.linalg.cholesky_ex(S2 * dsc[:, None] * dsc[None, :])
    y = torch.cholesky_solve((g.reshape(-1).to(S2.dtype) * dsc)[:, None],
                             L)[:, 0]
    dc = (y * dsc).reshape(n_cams, 12).to(g.dtype)
    return torch.where(info == 0, dc, torch.full_like(dc, float("nan")))


_SOLVE_DTYPE = {torch.bfloat16: torch.float32}
DTYPES = {"float64": torch.float64, "float32": torch.float32,
          "bfloat16": torch.bfloat16}


def solve_lm(problem: BAProblem, max_iterations: int, ftol: float,
             init_lambda: float, lambda_up: float, lambda_down: float,
             optimize_cameras: bool, dense: bool, cg_iters: int = 100,
             cg_tol: float = 1e-6):
    """Levenberg-Marquardt; returns (cams, points, final cost, iterations)."""
    cams, points = problem.cams, problem.points
    joint = bool(optimize_cameras)
    dense = joint and dense
    point = _point_segments(problem)
    tables = {"point": point,
              "cam": _camera_segments(problem) if joint else None,
              "pairs": _pair_structure(problem, point) if dense else None}

    def cost_of(c, p):
        return total_cost(c, p, problem.cam_idx, problem.point_idx,
                          problem.obs_2d, problem.mask)

    lam = torch.tensor(init_lambda, dtype=cams.dtype, device=cams.device)
    cost = cost_of(cams, points)
    iteration = 0
    done = False
    while not done and iteration < max_iterations:
        blocks = _assemble(problem, cams, points, tables, joint)
        Vinv = inv3(_damp_diag(blocks["V"], lam))
        if joint:
            U_lam = _damp_diag(blocks["U"], lam)
            vb = torch.einsum("pij,pj->pi", Vinv, blocks["b_p"])
            g = blocks["b_c"] - _to_cameras(problem, tables, blocks["W"], vb)
            if dense:
                dc = _dense_schur_dc(tables, blocks, U_lam, Vinv, g)
            else:
                def matvec(x):
                    a_p = _to_points(problem, tables, blocks["W"], x)
                    b_vp = torch.einsum("pij,pj->pi", Vinv, a_p)
                    return (torch.einsum("nij,nj->ni", U_lam, x)
                            - _to_cameras(problem, tables, blocks["W"], b_vp))
                Minv = torch.linalg.inv(U_lam.to(_SOLVE_DTYPE.get(
                    U_lam.dtype, U_lam.dtype))).to(U_lam.dtype)
                dc = _pcg(matvec, g, Minv, cg_iters, cg_tol)
            wtd = _to_points(problem, tables, blocks["W"], dc)
            dp = torch.einsum("pij,pj->pi", Vinv, blocks["b_p"] - wtd)
            new_cams = cams + dc
        else:
            dp = torch.einsum("pij,pj->pi", Vinv, blocks["b_p"])
            new_cams = cams
        new_points = points + dp
        new_cost = cost_of(new_cams, new_points)
        accept = new_cost < cost
        rel_decrease = (cost - new_cost) / torch.clamp_min(cost, 1e-30)
        stop = (accept & (rel_decrease < ftol)) | (lam > 1e8)
        lam = torch.where(accept, lam * lambda_down, lam * lambda_up)
        cost = torch.where(accept, new_cost, cost)
        iteration += 1
        accepted, done = torch.stack([accept, stop]).tolist()
        if accepted:
            cams, points = new_cams, new_points
    return cams, points, cost, iteration


def dense_gate(track_lengths, n_cams: int, bc: dict) -> bool:
    """Whether the joint solve takes the dense reduced camera system: the
    camera count, the JAX package's grid bytes and the port's pair bytes
    within their bounds (the program's ``ba.run.dense_gate``)."""
    n_tracks = len(track_lengths)
    itemsize = 8 if bc["dtype"] == "float64" else 4  # the program's count
    _, pair_bytes = pair_assembly_bytes(
        track_lengths, _pad_len(n_tracks, 1024), itemsize)
    grid_bytes = 4 * n_tracks * n_cams * 144
    return (bool(bc["refine_cameras"]) and n_tracks > 0
            and n_cams <= bc["dense_schur_max_cams"]
            and grid_bytes <= bc["dense_schur_max_bytes"]
            and pair_bytes <= bc["dense_schur_max_bytes"])


def bundle_adjust(K, R, t, world, offsets, obs, bc: dict, device):
    """Refine the track points (and with ``bc["refine_cameras"]`` the
    cameras) on ``device``.  Returns the refined world (T, 3) float64."""
    dtype = DTYPES[bc["dtype"]]
    problem = build_problem(K, R, t, world, offsets, obs, dtype=dtype,
                            device=device)
    _, points, _, _ = solve_lm(
        problem, max_iterations=bc["max_iterations"], ftol=bc["ftol"],
        init_lambda=bc["init_lambda"], lambda_up=bc["lambda_up"],
        lambda_down=bc["lambda_down"],
        optimize_cameras=bc["refine_cameras"],
        dense=dense_gate(np.diff(offsets), K.shape[0], bc),
    )
    return points.double().cpu().numpy()[: world.shape[0]]
