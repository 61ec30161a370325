"""Plain SE(3) pose-graph Levenberg-Marquardt with a block-Jacobi
preconditioned CG solve, written from the port's stated method
(backend/pose_graph.py's docstring): the residual of an edge (i, j)
measuring T_m is r = log(T_m^-1 (T_i e^xi_i)^-1 (T_j e^xi_j)) with right
perturbations; each edge weighs its residual's translation by w t_w and
its rotation by w r_w; an iteration solves (J^T W J + lam I) dx = -J^T W r
with node 0 and the invalid nodes held fixed, by a fixed number of CG
steps preconditioned with each node's 6 x 6 diagonal block (lam + 1e-6
on its diagonal), retracts T <- T e^dx, keeps the step when it lowers
the cost and then halves lam, else keeps the poses and multiplies lam by 4,
lam within [1e-9, 1e6]. The Jacobians come from torch.func's reverse
mode of the residual below. Works on the graph it is given (the caller
passes the live nodes and the valid edges only). Torch only; imports
nothing of the program.
"""

from __future__ import annotations

import torch
from torch.func import jacrev, vmap


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def _angle(v, small2):
    """|v| where |v|^2 >= small2, else 1 (so that no branch divides by 0
    or differentiates sqrt at 0); with the mask of the small ones and
    |v|^2."""
    n2 = (v * v).sum(-1)
    small = n2 < small2
    return torch.sqrt(torch.where(small, torch.ones_like(n2), n2)), small, n2


def exp(xi):
    """Twist (..., 6) [rho, phi] -> (..., 4, 4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    a, small, n2 = _angle(phi, 1e-12)
    a, small, n2 = a[..., None, None], small[..., None, None], n2[..., None, None]
    K = skew(phi)
    K2 = K @ K
    A = torch.where(small, 1.0 - n2 / 6.0, torch.sin(a) / a)
    B = torch.where(small, 0.5 - n2 / 24.0, (1.0 - torch.cos(a)) / (a * a))
    C = torch.where(small, 1.0 / 6.0 - n2 / 120.0, (a - torch.sin(a)) / (a * a * a))
    eye = _eye(3, xi)
    R = eye + A * K + B * K2
    t = ((eye + B * K + C * K2) @ rho[..., None])[..., 0]
    return make(R, t)


def make(R, t):
    top = torch.cat([R, t[..., None]], -1)
    zero = torch.zeros_like(top[..., :1, :1])
    return torch.cat([top, torch.cat([zero, zero, zero, torch.ones_like(zero)], -1)], -2)


def inverse(T):
    Rt = T[..., :3, :3].transpose(-1, -2)
    return make(Rt, -(Rt @ T[..., :3, 3:])[..., 0])


def _quat(R):
    """Unit quaternion (w, x, y, z) of R by Shepperd's rule: the branch of
    the largest of 1 + trace and the diagonal's three."""
    r = R
    tr = r[..., 0, 0] + r[..., 1, 1] + r[..., 2, 2]
    cands = torch.stack([tr, r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]], -1)
    k = cands.argmax(-1)

    def s(x):  # 2 sqrt(1 + x), kept off 0 where a branch is not taken
        return 2.0 * torch.sqrt(torch.clamp(1.0 + x, min=1e-12))

    s0 = s(tr)
    q0 = torch.stack([0.25 * s0, (r[..., 2, 1] - r[..., 1, 2]) / s0,
                      (r[..., 0, 2] - r[..., 2, 0]) / s0, (r[..., 1, 0] - r[..., 0, 1]) / s0], -1)
    s1 = s(r[..., 0, 0] - r[..., 1, 1] - r[..., 2, 2])
    q1 = torch.stack([(r[..., 2, 1] - r[..., 1, 2]) / s1, 0.25 * s1,
                      (r[..., 0, 1] + r[..., 1, 0]) / s1, (r[..., 0, 2] + r[..., 2, 0]) / s1], -1)
    s2 = s(r[..., 1, 1] - r[..., 0, 0] - r[..., 2, 2])
    q2 = torch.stack([(r[..., 0, 2] - r[..., 2, 0]) / s2, (r[..., 0, 1] + r[..., 1, 0]) / s2,
                      0.25 * s2, (r[..., 1, 2] + r[..., 2, 1]) / s2], -1)
    s3 = s(r[..., 2, 2] - r[..., 0, 0] - r[..., 1, 1])
    q3 = torch.stack([(r[..., 1, 0] - r[..., 0, 1]) / s3, (r[..., 0, 2] + r[..., 2, 0]) / s3,
                      (r[..., 1, 2] + r[..., 2, 1]) / s3, 0.25 * s3], -1)
    q = torch.where((k == 0)[..., None], q0, torch.where(
        (k == 1)[..., None], q1, torch.where((k == 2)[..., None], q2, q3)))
    q = torch.where(q[..., :1] < 0, -q, q)  # the shortest arc
    return q / q.norm(dim=-1, keepdim=True)


def log(T):
    """(..., 4, 4) -> twist (..., 6) [rho, phi]."""
    q = _quat(T[..., :3, :3])
    w, v = q[..., 0], q[..., 1:]
    vn, vsmall, _ = _angle(v, 1e-16)
    scale = torch.where(vsmall, 2.0 / w, 2.0 * torch.atan2(vn, w) / vn)
    phi = v * scale[..., None]
    a, small, n2 = _angle(phi, 1e-12)
    a, small, n2 = a[..., None, None], small[..., None, None], n2[..., None, None]
    K = skew(phi)
    coef = torch.where(small, 1.0 / 12.0 + n2 / 720.0,
                       (1.0 - a * torch.cos(a / 2.0) / (2.0 * torch.sin(a / 2.0))) / (a * a))
    Vinv = _eye(3, T) - 0.5 * K + coef * (K @ K)
    rho = (Vinv @ T[..., :3, 3:])[..., 0]
    return torch.cat([rho, phi], -1)


def residual(Ti, Tj, Tm, xi_i, xi_j):
    return log(inverse(Tm) @ inverse(Ti @ exp(xi_i)) @ (Tj @ exp(xi_j)))


def weights6(w, twt, rwt):
    return w[:, None] * torch.stack([twt] * 3 + [rwt] * 3, -1)


def cost(poses, ei, ej, rel, w6):
    z = torch.zeros(rel.shape[:-2] + (6,), dtype=poses.dtype, device=poses.device)
    r = residual(poses[ei], poses[ej], rel, z, z)
    return (w6 * r * r).sum()


def linearize(poses, ei, ej, rel):
    """Residuals (E, 6) and the Jacobian blocks (E, 6, 6) of xi_i, xi_j."""
    Ti, Tj = poses[ei], poses[ej]

    def one(x, a, b, m):
        return residual(a, b, m, x[:6], x[6:])

    x0 = torch.zeros(rel.shape[0], 12, dtype=poses.dtype, device=poses.device)
    J = vmap(jacrev(one))(x0, Ti, Tj, rel)
    r = residual(Ti, Tj, rel, x0[:, :6], x0[:, 6:])
    return r, J[..., :6], J[..., 6:]


def solve(n, ei, ej, r, Ji, Jj, w6, free, lam, cg_iterations):
    """The damped normal equations' step dx (n, 6) by block-Jacobi PCG."""
    dev, dt = r.device, r.dtype
    f = free.to(dt)[:, None]

    def gather_t(J, y):  # J^T y per edge
        return (J.transpose(-1, -2) @ y[..., None])[..., 0]

    def scatter(idx, vals):
        return torch.zeros((n,) + vals.shape[1:], dtype=dt, device=dev).index_add_(0, idx, vals)

    def hvp(x):
        x = x * f
        y = ((Ji @ x[ei][..., None]) + (Jj @ x[ej][..., None]))[..., 0] * w6
        return (scatter(ei, gather_t(Ji, y)) + scatter(ej, gather_t(Jj, y)) + lam * x) * f

    b = -(scatter(ei, gather_t(Ji, r * w6)) + scatter(ej, gather_t(Jj, r * w6))) * f
    blocks = (scatter(ei, Ji.transpose(-1, -2) @ (Ji * w6[..., None]))
              + scatter(ej, Jj.transpose(-1, -2) @ (Jj * w6[..., None])))
    Minv = torch.linalg.inv(blocks + (lam + 1e-6) * _eye(6, r))

    def precond(x):
        return (Minv @ x[..., None])[..., 0] * f

    def guard(d):
        return torch.where(d.abs() < 1e-20, torch.full_like(d, 1e-20), d)

    x = torch.zeros_like(b)
    res = b
    z = precond(res)
    p = z
    for _ in range(cg_iterations):
        Ap = hvp(p)
        rz = (res * z).sum()
        alpha = rz / guard((p * Ap).sum())
        x = x + alpha * p
        res = res - alpha * Ap
        z = precond(res)
        beta = (res * z).sum() / guard(rz)
        p = z + beta * p
    return x


def optimize(poses, valid, ei, ej, rel, w, twt, rwt, iterations, cg_iterations, init_lambda):
    """poses (N, 4, 4) and valid (N,) of the nodes, the edges' ends ei, ej
    (E,), measurements rel (E, 4, 4), weights w, twt, rwt (E,) -> the
    optimised poses (N, 4, 4)."""
    ei, ej = ei.long(), ej.long()
    n = poses.shape[0]
    free = valid & (torch.arange(n, device=poses.device) != 0)
    w6 = weights6(w, twt, rwt)
    lam = torch.tensor(init_lambda, dtype=poses.dtype, device=poses.device)
    for _ in range(iterations):
        r, Ji, Jj = linearize(poses, ei, ej, rel)
        dx = solve(n, ei, ej, r, Ji, Jj, w6, free, lam, cg_iterations)
        trial = poses @ exp(dx)
        better = cost(trial, ei, ej, rel, w6) < cost(poses, ei, ej, rel, w6)
        poses = torch.where(better, trial, poses)
        lam = torch.clamp(torch.where(better, lam * 0.5, lam * 4.0), 1e-9, 1e6)
    return poses
