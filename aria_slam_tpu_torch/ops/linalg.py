"""Small batched linear algebra, statically unrolled (counterpart of the
JAX package's ops/linalg.py).

The same algorithms as the reference, step for step (column-by-column
Cholesky, regularised inverse iteration, cyclic Jacobi), so iteration
counts, eigenvector signs and the near-degenerate behaviour RANSAC
relies on match. torch.linalg's LAPACK/cuSOLVER routines would pick
other signs and other orders.

The triangular steps' short contractions go through `dot` and `matvec`.
On the card they are a product and a sum over the last axis: einsum runs
them as a batched GEMM whose kernel cuBLAS picks by the batch count, so
one system rounded differently in another batch (a sequence's RANSAC at
S = 4 sequences against S = 1 in eval/multi_eval.py, found with
tools/multi_batch_diff.py), while the sum's order depends only on the
length of the summed axis. On the CPU they stay einsum, whose rounding
the parity tests hold against the reference.
"""

from __future__ import annotations

import torch


def dot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum(a * b) over the short last axis: (..., k), (..., k) -> (...),
    the same rounding for a row in any batch on the card."""
    if a.is_cuda:
        return (a * b).sum(-1)
    return torch.einsum("...k,...k->...", a, b)


def matvec(M: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """M (..., m, k) times v (..., k) -> (..., m), k short, the same
    rounding for a row in any batch on the card."""
    if M.is_cuda:
        return (M * v[..., None, :]).sum(-1)
    return torch.einsum("...ik,...k->...i", M, v)


def cholesky_unrolled(M: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky of SPD (..., n, n), n static and small."""
    n = M.shape[-1]
    row_idx = torch.arange(n, device=M.device)
    cols = []
    for j in range(n):
        s = M[..., :, j]
        if j > 0:
            Lj = torch.stack([c[..., j] for c in cols], -1)   # (..., j)
            Lprev = torch.stack(cols, -1)                    # (..., n, j)
            s = s - matvec(Lprev, Lj)
        d = torch.sqrt(torch.clamp(s[..., j], min=1e-20))
        col = s / d[..., None]
        col = torch.where(row_idx >= j, col, 0.0)  # zero the strict upper part
        cols.append(col)
    return torch.stack(cols, -1)


def solve_lower(L: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve L y = b, L (..., n, n) lower triangular, b (..., n)."""
    n = L.shape[-1]
    ys = []
    for i in range(n):
        s = b[..., i]
        if i > 0:
            s = s - dot(L[..., i, :i], torch.stack(ys, -1))
        ys.append(s / L[..., i, i])
    return torch.stack(ys, -1)


def solve_upper_t(L: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Solve L^T x = y (L lower triangular)."""
    n = L.shape[-1]
    xs = [None] * n
    for i in reversed(range(n)):
        s = y[..., i]
        if i < n - 1:
            s = s - dot(L[..., i + 1:, i], torch.stack(xs[i + 1:], -1))
        xs[i] = s / L[..., i, i]
    return torch.stack(xs, -1)


def cholesky_solve(M: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve M x = b for SPD M (..., n, n)."""
    L = cholesky_unrolled(M)
    return solve_upper_t(L, solve_lower(L, b))


def smallest_eigvec(M: torch.Tensor, iters: int = 8,
                    eps_scale: float = 1e-6) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD
    (..., n, n) by regularised inverse iteration (factor once, `iters`
    solves)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    scale = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)[..., None, None] / n
    eps = eps_scale * torch.clamp(scale, min=1e-20)
    L = cholesky_unrolled(M + eps * eye)
    v = (torch.ones(M.shape[:-2] + (n,), dtype=M.dtype, device=M.device)
         + torch.arange(n, dtype=M.dtype, device=M.device) * 0.1)
    v = v / torch.linalg.norm(v, dim=-1, keepdim=True)
    for _ in range(iters):
        w = solve_upper_t(L, solve_lower(L, v))
        v = w / torch.clamp(torch.linalg.norm(w, dim=-1, keepdim=True), min=1e-20)
    return v


def inv_psd(M: torch.Tensor) -> torch.Tensor:
    """Inverse of SPD (..., n, n) by unrolled Cholesky column solves."""
    n = M.shape[-1]
    L = cholesky_unrolled(M)
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    cols = [solve_upper_t(L, solve_lower(L, eye[i].expand(M.shape[:-2] + (n,))))
            for i in range(n)]
    return torch.stack(cols, -1)


def _jacobi_rotation(App, Aqq, Apq):
    """Givens (c, s) diagonalising the 2x2 block [[App, Apq], [Apq, Aqq]]."""
    tiny = torch.abs(Apq) < 1e-30
    tau = (Aqq - App) / (2.0 * torch.where(tiny, 1e-30, Apq))
    t = torch.sign(tau) / (torch.abs(tau) + torch.sqrt(1.0 + tau * tau))
    t = torch.where(tiny, 0.0, t)
    c = 1.0 / torch.sqrt(1.0 + t * t)
    return c, t * c


def eigh3(M: torch.Tensor, sweeps: int = 6):
    """Symmetric (..., 3, 3) eigendecomposition by unrolled cyclic Jacobi.
    Returns (eigenvalues (..., 3) ascending, eigenvectors (..., 3, 3) as
    columns)."""
    eye = torch.eye(3, dtype=M.dtype, device=M.device)
    A = M
    V = eye.expand(M.shape).clone()
    for _ in range(sweeps):
        for (p, q) in ((0, 1), (0, 2), (1, 2)):
            c, s = _jacobi_rotation(A[..., p, p], A[..., q, q], A[..., p, q])
            J = eye.expand(M.shape).clone()
            J[..., p, p] = c
            J[..., q, q] = c
            J[..., p, q] = s
            J[..., q, p] = -s
            A = J.transpose(-1, -2) @ A @ J
            V = V @ J
    w = torch.stack([A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]], -1)
    order = torch.argsort(w, dim=-1, stable=True)
    w_sorted = torch.take_along_dim(w, order, -1)
    V_sorted = torch.take_along_dim(V, order[..., None, :].expand(V.shape), -1)
    return w_sorted, V_sorted


def svd3(E: torch.Tensor):
    """SVD of (..., 3, 3) -> (U, S, Vt) with S descending, via eigh3 of
    E^T E and U rebuilt column-wise with a cross-product third column
    (exact for rank-2 essential matrices)."""
    w, V = eigh3(E.transpose(-1, -2) @ E)  # ascending
    w = torch.flip(w, (-1,))
    V = torch.flip(V, (-1,))
    S = torch.sqrt(torch.clamp(w, min=0.0))
    EV = E @ V  # columns = E v_i = s_i u_i
    u0 = EV[..., :, 0] / torch.clamp(S[..., 0:1], min=1e-20)
    u1 = EV[..., :, 1] / torch.clamp(S[..., 1:2], min=1e-20)
    u1 = u1 - torch.sum(u0 * u1, -1, keepdim=True) * u0
    u1 = u1 / torch.clamp(torch.linalg.norm(u1, dim=-1, keepdim=True), min=1e-20)
    u2 = torch.linalg.cross(u0, u1, dim=-1)
    # align u2 with E v2 when s2 is nonzero (for rank-2 E the sign is free)
    ev2 = EV[..., :, 2]
    sgn = torch.sign(torch.sum(ev2 * u2, -1, keepdim=True))
    sgn = torch.where(S[..., 2:3] < 1e-6 * torch.clamp(S[..., 0:1], min=1e-20),
                      1.0, torch.where(sgn == 0.0, 1.0, sgn))
    u2 = u2 * sgn
    U = torch.stack([u0, u1, u2], -1)
    return U, S, V.transpose(-1, -2)


def det3(M: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactor expansion (used for signs)."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2] - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1] - M[..., 1, 1] * M[..., 2, 0]))
