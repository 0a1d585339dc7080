"""Plain geometry of the reference: rotations, pinhole and BA camera
projection, closed-form 3x3 solves, smallest eigenvectors, DLT
triangulation with Gauss-Newton refinement, the weighted 8-point solver and
Sampson distances, and ray utilities.

A frozen copy of ``sfm_tpu_torch/geometry/`` (``rotations.py``,
``projection.py``, ``linalg3.py``, ``nullvec.py``, ``triangulation.py``,
``epipolar.py``) at commit bfc7f14, in one module, without the functions no
reference stage calls.  Plain PyTorch; imports nothing of the program.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-12
def _cross(a, b):
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate_points(points, rotvecs):
    """Rotate ``points`` (..., 3) by axis-angle ``rotvecs`` (..., 3).

    Rodrigues: v' = v cos t + (k x v) sin t + k (k . v)(1 - cos t); the
    t -> 0 neighbourhood takes v + w x v + 0.5 w x (w x v).
    """
    theta2 = torch.sum(rotvecs * rotvecs, dim=-1, keepdim=True)
    small = theta2 < 1e-14
    theta = torch.sqrt(torch.where(small, torch.ones_like(theta2), theta2))
    k = rotvecs / theta
    cos = torch.cos(theta)
    sin = torch.sin(theta)
    dot = torch.sum(k * points, dim=-1, keepdim=True)
    main = points * cos + _cross(k, points) * sin + k * dot * (1.0 - cos)
    cross_w = _cross(rotvecs, points)
    taylor = points + cross_w + 0.5 * _cross(rotvecs, cross_w)
    return torch.where(small, taylor, main)


def rodrigues_vector(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3), theta in [0, pi]."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos)
    ax = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        dim=-1,
    )
    sin = torch.sin(theta)
    small = theta[..., None] < 1e-6
    near_pi = (math.pi - theta[..., None]) < 1e-4
    axis_gen = ax / torch.clamp_min(2.0 * sin[..., None], _EPS)
    # theta -> pi: axis from the largest column of R + I, sign taken from
    # the antisymmetric part where it still carries it.
    M = R + torch.eye(3, dtype=R.dtype, device=R.device)
    col_norms = torch.sqrt(torch.sum(M * M, dim=-2))
    best = torch.argmax(col_norms, dim=-1)
    idx = best[..., None, None].expand(*M.shape[:-1], 1)
    col = torch.gather(M, -1, idx)[..., 0]
    axis_pi = col / torch.clamp_min(
        torch.sqrt(torch.sum(col * col, dim=-1, keepdim=True)), _EPS
    )
    sign = torch.where(
        torch.sum(axis_pi * ax, dim=-1, keepdim=True) < 0.0, -1.0, 1.0
    )
    axis = torch.where(near_pi, axis_pi * sign, axis_gen)
    rv = axis * theta[..., None]
    return torch.where(small, ax * 0.5, rv)
def _safe_z(cam):
    z = cam[..., 2:3]
    return torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)


def projection_matrix(K, R, t):
    """(...,3,3),(...,3,3),(...,3) -> (...,3,4) P = K [R|t]."""
    return K @ torch.cat([R, t[..., :, None]], dim=-1)


def project_pinhole(points, K, R, t):
    """Project world points (..., 3) with pinhole cameras -> pixels (..., 2)."""
    cam = torch.einsum("...ij,...j->...i", R, points) + t
    ndc = cam[..., :2] / _safe_z(cam)
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    skew = K[..., 0, 1]
    u = fx * ndc[..., 0] + skew * ndc[..., 1] + cx
    v = fy * ndc[..., 1] + cy
    return torch.stack([u, v], dim=-1)


def pack_cam(K, R_rotvec, t):
    """12-param BA camera vector [rvec, t, fx, fy, k1=0, k2=0, px, py]."""
    fx = K[..., 0, 0]
    zeros = torch.zeros_like(fx)
    return torch.cat(
        [
            R_rotvec, t, fx[..., None], K[..., 1, 1][..., None],
            zeros[..., None], zeros[..., None],
            K[..., 0, 2][..., None], K[..., 1, 2][..., None],
        ],
        dim=-1,
    )


def project_cam(points, cams):
    """Project points (..., 3) with 12-param cameras (..., 12) -> (..., 2):
    rotate, translate, divide, radial r = 1 + k1 n + k2 n^2, scale, shift."""
    cam = rotate_points(points, cams[..., 0:3]) + cams[..., 3:6]
    xy = cam[..., :2] / _safe_z(cam)
    n = torch.sum(xy * xy, dim=-1, keepdim=True)
    k1 = cams[..., 8:9]
    k2 = cams[..., 9:10]
    r = 1.0 + k1 * n + k2 * n * n
    return xy * r * cams[..., 6:8] + cams[..., 10:12]


def _entries(M):
    return [[M[..., i, j] for j in range(3)] for i in range(3)]


def adjugate3(M):
    """Batched adjugate of (..., 3, 3)."""
    (a, b, c), (d, e, f), (g, h, i) = _entries(M)
    return torch.stack(
        [
            torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
            torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
            torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
        ],
        -2,
    )


def det3(M):
    (a, b, c), (d, e, f), (g, h, i) = _entries(M)
    return a * (e * i - f * h) - b * (d * i - f * g) + c * (d * h - e * g)


def _safe_det(M, eps):
    det = det3(M)
    return torch.where(det.abs() < eps, torch.full_like(det, eps), det)


def inv3(M, eps: float = 1e-30):
    """Batched closed-form inverse of (..., 3, 3)."""
    return adjugate3(M) / _safe_det(M, eps)[..., None, None]


def solve3(M, b, eps: float = 1e-30):
    """Solve (..., 3, 3) @ x = (..., 3) in closed form."""
    x = torch.einsum("...ij,...j->...i", adjugate3(M), b)
    return x / _safe_det(M, eps)[..., None]
def _norm(v):
    return torch.sqrt(torch.sum(v * v, dim=-1, keepdim=True))


def cholesky_unrolled(A):
    """Cholesky of (..., k, k) SPD matrices, unrolled over static k.

    Returns the lower factor as a list of lists of (...,) entries.  Pivots
    are clamped to a tiny positive floor so nearly singular inputs stay
    finite.
    """
    k = A.shape[-1]
    L = [[None] * (i + 1) for i in range(k)]
    for i in range(k):
        for j in range(i + 1):
            s = A[..., i, j]
            for p in range(j):
                s = s - L[i][p] * L[j][p]
            if i == j:
                L[i][j] = torch.sqrt(torch.clamp_min(s, 1e-30))
            else:
                L[i][j] = s / L[j][j]
    return L


def cho_solve_unrolled(L, b):
    """Solve (L L^T) x = b with the factor from cholesky_unrolled; b (..., k)."""
    k = len(L)
    y = [None] * k
    for i in range(k):
        s = b[..., i]
        for p in range(i):
            s = s - L[i][p] * y[p]
        y[i] = s / L[i][i]
    x = [None] * k
    for i in reversed(range(k)):
        s = y[i]
        for p in range(i + 1, k):
            s = s - L[p][i] * x[p]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def smallest_eigvec(M, iters: int = 4, eps_rel: float = 1e-6):
    """Unit eigenvector for the smallest eigenvalue of PSD (..., k, k) M.

    Inverse iteration on M + eps*I, eps = eps_rel * mean(diag).  Same
    precondition as the JAX version: a poorly separated spectrum (degenerate
    RANSAC sample) may not converge in ``iters`` steps; both callers filter
    such results downstream (Sampson vote, reprojection gate).
    """
    k = M.shape[-1]
    diag = torch.diagonal(M, dim1=-2, dim2=-1)
    eps = eps_rel * torch.mean(diag, dim=-1) + 1e-30
    A = M + eps[..., None, None] * torch.eye(k, dtype=M.dtype, device=M.device)
    L = cholesky_unrolled(A)
    v = torch.full(M.shape[:-1], 1.0 / (k ** 0.5), dtype=M.dtype,
                   device=M.device)
    for _ in range(iters):
        v = cho_solve_unrolled(L, v)
        v = v / torch.clamp_min(_norm(v), 1e-30)
    return v
def _dlt_rows(P, pix):
    """DLT row pair per view: (..., 3, 4) proj, (..., 2) pixel -> (..., 2, 4)."""
    r0 = pix[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = pix[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    return torch.stack([r0, r1], dim=-2)


def dehomogenize(X):
    """(..., 4) homogeneous -> ((..., 3), w) with a w == 0 guard."""
    w = X[..., 3]
    eps = torch.full_like(w, _EPS)
    denom = torch.where(w.abs() < _EPS, torch.where(w < 0, -eps, eps), w)
    return X[..., :3] / denom[..., None], w


def triangulate_dlt(P, pixels, mask=None):
    """Triangulate world points from multi-view observations.

    P (..., V, 3, 4), pixels (..., V, 2), optional mask (..., V).
    Returns (points (..., 3), w (...,)); |w| near 0 flags an ill-conditioned
    point.
    """
    rows = _dlt_rows(P, pixels)  # (..., V, 2, 4)
    if mask is not None:
        rows = rows * mask[..., None, None].to(rows.dtype)
    A = rows.reshape(*rows.shape[:-3], -1, 4)
    norms = torch.sqrt(torch.sum(A * A, dim=-1, keepdim=True))
    A = A / torch.clamp_min(norms, _EPS)
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    return dehomogenize(smallest_eigvec(AtA))


def refine_triangulation(P, pixels, X, mask=None, iters: int = 2):
    """Gauss-Newton steps on the reprojection residual (restores sub-0.1 px
    accuracy in f32 for the 0.3 px insertion gate).

    P (..., V, 3, 4), pixels (..., V, 2), X (..., 3) -> refined X.
    """
    eye = torch.eye(3, dtype=X.dtype, device=X.device)
    for _ in range(iters):
        Xh = torch.cat([X, torch.ones_like(X[..., :1])], dim=-1)
        h = torch.einsum("...vij,...j->...vi", P, Xh)
        z = h[..., 2:3]
        z = torch.where(z.abs() < _EPS, torch.full_like(z, _EPS), z)
        uv = h[..., :2] / z
        r = uv - pixels
        J = (P[..., :2, :3] - uv[..., :, None] * P[..., 2:3, :3]) / z[..., None]
        if mask is not None:
            m = mask[..., None].to(r.dtype)
            r = r * m
            J = J * m[..., None]
        Jf = J.reshape(*J.shape[:-3], -1, 3)
        rf = r.reshape(*r.shape[:-2], -1)
        JtJ = torch.einsum("...ki,...kj->...ij", Jf, Jf) + 1e-6 * eye
        Jtr = torch.einsum("...ki,...k->...i", Jf, rf)
        X = X - solve3(JtJ, Jtr)
    return X


def ray_plane_intersection(origin, direction, plane_point, plane_normal):
    """Intersect rays with planes -> (point (..., 3), valid (...,)); valid is
    False for rays (near-)parallel to the plane."""
    denom = torch.sum(direction * plane_normal, dim=-1)
    num = torch.sum((plane_point - origin) * plane_normal, dim=-1)
    valid = denom.abs() > 1e-9
    s = num / torch.where(valid, denom, torch.ones_like(denom))
    return origin + s[..., None] * direction, valid


def backproject_pixel(pix, K, R, t):
    """Pixel (..., 2) -> (camera center (..., 3), unit world ray (..., 3))."""
    fx = K[..., 0, 0]
    fy = K[..., 1, 1]
    cx = K[..., 0, 2]
    cy = K[..., 1, 2]
    skew = K[..., 0, 1]
    y = (pix[..., 1] - cy) / fy
    x = (pix[..., 0] - cx - skew * y) / fx
    d_cam = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    d_world = torch.einsum("...ji,...j->...i", R, d_cam)
    d_world = d_world / torch.clamp_min(
        torch.sqrt(torch.sum(d_world * d_world, dim=-1, keepdim=True)), _EPS
    )
    center = -torch.einsum("...ji,...j->...i", R, t)
    return center, d_world
def _normalize(pts, weights):
    """Hartley normalization: centroid to origin, mean distance sqrt(2).

    Returns (normalized points (..., N, 2), T (..., 3, 3))."""
    wsum = torch.clamp_min(torch.sum(weights, dim=-1, keepdim=True), _EPS)
    centroid = torch.sum(pts * weights[..., None], dim=-2) / wsum
    d = pts - centroid[..., None, :]
    dist = torch.sqrt(torch.sum(d * d, dim=-1))
    mean_dist = torch.sum(dist * weights, dim=-1) / wsum[..., 0]
    s = math.sqrt(2.0) / torch.clamp_min(mean_dist, _EPS)
    zeros = torch.zeros_like(s)
    ones = torch.ones_like(s)
    T = torch.stack(
        [
            torch.stack([s, zeros, -s * centroid[..., 0]], dim=-1),
            torch.stack([zeros, s, -s * centroid[..., 1]], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
    return d * s[..., None, None], T


def eight_point(pts1, pts2, weights=None):
    """Weighted normalized 8-point fundamental-matrix estimate.

    pts1, pts2 (..., N, 2); weights (..., N) nonnegative (default ones).
    Returns (..., 3, 3) rank-2 F with unit Frobenius norm, x2^T F x1 ~ 0.
    """
    if weights is None:
        weights = torch.ones(pts1.shape[:-1], dtype=pts1.dtype,
                             device=pts1.device)
    n1, T1 = _normalize(pts1, weights)
    n2, T2 = _normalize(pts2, weights)
    x1, y1 = n1[..., 0], n1[..., 1]
    x2, y2 = n2[..., 0], n2[..., 1]
    A = torch.stack(
        [x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
         torch.ones_like(x1)],
        dim=-1,
    )
    A = A * weights[..., None]
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    f = smallest_eigvec(AtA)
    F = f.reshape(*f.shape[:-1], 3, 3)
    # Rank-2: with v3 the smallest right singular vector, F - (F v3) v3^T is
    # U diag(s1, s2, 0) V^T exactly — no SVD.
    FtF = torch.einsum("...ki,...kj->...ij", F, F)
    v3 = smallest_eigvec(FtF)
    F = F - torch.einsum("...ij,...j->...i", F, v3)[..., :, None] * v3[..., None, :]
    F = T2.transpose(-1, -2) @ F @ T1
    norm = torch.sqrt(torch.sum(F * F, dim=(-2, -1), keepdim=True))
    return F / torch.clamp_min(norm, _EPS)


def _homog(pts):
    return torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)


def _lines(F, pts1, pts2):
    x1 = _homog(pts1)
    x2 = _homog(pts2)
    Fx1 = torch.einsum("...ij,...nj->...ni", F, x1)
    Ftx2 = torch.einsum("...ji,...nj->...ni", F, x2)
    return x2, Fx1, Ftx2


def sampson_distance(F, pts1, pts2):
    """First-order geometric (Sampson) distance, (..., N) in px^2."""
    x2, Fx1, Ftx2 = _lines(F, pts1, pts2)
    num = torch.sum(x2 * Fx1, dim=-1) ** 2
    den = (
        Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2
        + Ftx2[..., 1] ** 2
    )
    return num / torch.clamp_min(den, _EPS)


