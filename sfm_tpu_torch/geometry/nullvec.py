"""Smallest-eigenvector extraction for small batched symmetric matrices.

DLT triangulation (4x4) and the weighted 8-point solver (9x9) need the
eigenvector of the smallest eigenvalue of a PSD normal matrix.  Counterpart
of ``sfm_tpu/geometry/nullvec.py``: a Cholesky factor unrolled over the
static k, then a few inverse-iteration steps, all elementwise over the
batch — tens of thousands of tiny eigenproblems (512 RANSAC hypotheses per
pair, one 4x4 per match) never go through a batched ``eigh``.
"""

from __future__ import annotations

import torch


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
