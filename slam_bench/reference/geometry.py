"""Plain two-view geometry: Hamming kNN-2 with the ratio test, essential
RANSAC with a refit, cheirality and a dominant-plane homography rescue,
a Sampson Gauss-Newton polish on the essential manifold, the gyro's
rotation over each frame pair, the linear translation under it, and the
depth pins. Written
from the reference system's description (OpenCV findEssentialMat with
prob 0.999 and a 1 px threshold, then recoverPose, as the JAX package
fixes it): the minimal solves are 8-point null vectors from
torch.linalg.eigh, decompositions use torch.linalg.svd, the polish takes
its Jacobian by forward-mode autodiff. Minimal samples are inputs: the
draws the program made, in the order it made them. Torch only; imports
nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import jvp

BIG = 1 << 20
CLIP = 1024


# ------------------------------------------------------------- matching
def top2(desc_q, desc_t, valid_t):
    """(..., Kq, B), (..., Kt, B) {0,1} int8, (..., Kt) bool -> best,
    second distance and the best's train index (..., Kq): ties to the
    lowest index, an invalid train column at CLIP, and a distance of
    CLIP or more reported as BIG."""
    q = desc_q.to(torch.int32)
    t = desc_t.to(torch.int32)
    dots = torch.einsum("...qb,...tb->...qt", desc_q.double(), desc_t.double()).to(torch.int32)
    dist = q.sum(-1)[..., :, None] + t.sum(-1)[..., None, :] - 2 * dots
    dist = torch.where(valid_t[..., None, :], torch.clamp(dist, max=CLIP), CLIP)
    best, idx = dist.min(-1)  # the first minimum
    others = dist.scatter(-1, idx[..., None], CLIP + 1)
    second = others.amin(-1)
    best = torch.where(best >= CLIP, BIG, best)
    second = torch.where(second >= CLIP, BIG, second)
    return best, second, idx


def ratio_gate(valid_q, best, second, ratio):
    return valid_q & (best.float() < ratio * second.float()) & (best < BIG)


# ----------------------------------------------------------- small algebra
def homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def skew(v):
    z = torch.zeros_like(v[..., 0])
    return torch.stack([torch.stack([z, -v[..., 2], v[..., 1]], -1),
                        torch.stack([v[..., 2], z, -v[..., 0]], -1),
                        torch.stack([-v[..., 1], v[..., 0], z], -1)], -2)


def so3_exp(phi):
    th2 = (phi * phi).sum(-1)[..., None, None]
    th = torch.sqrt(torch.clamp(th2, min=1e-30))
    small = th2 < 1e-10
    a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / torch.clamp(th2, min=1e-30))
    K = skew(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + a * K + b * (K @ K)


def normalize(xy, K):
    return torch.stack([(xy[..., 0] - K[0, 2]) / K[0, 0], (xy[..., 1] - K[1, 2]) / K[1, 1]], -1)


def null_vector(M):
    """Unit eigenvector of the smallest eigenvalue of symmetric M."""
    return torch.linalg.eigh(M)[1][..., 0]


def null_vector_9(M, iters=3):
    """The 9x9 null vectors as the reference system computes them: three
    steps of inverse iteration on M + 1e-6 (trace / 9) I from the start
    (1, 1.1, ..., 1.8) normalised (its estimate, not the exact vector,
    which the refits' near-degenerate normal matrices would not reach)."""
    n = M.shape[-1]
    eye = torch.eye(n, dtype=M.dtype, device=M.device)
    eps = 1e-6 * torch.clamp(torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / n, min=1e-20)
    L, info = torch.linalg.cholesky_ex(M + eps[..., None, None] * eye)
    for _ in range(6):
        # a matrix that rounding left indefinite gets a larger shift
        bad = info != 0
        if not bool(bad.any()):
            break
        eps = torch.where(bad, eps * 1e2, eps)
        L, info = torch.linalg.cholesky_ex(M + eps[..., None, None] * eye)
    v = 1.0 + 0.1 * torch.arange(n, dtype=M.dtype, device=M.device)
    v = (v / torch.linalg.norm(v)).expand(M.shape[:-1])[..., None]
    for _ in range(iters):
        w = torch.cholesky_solve(v, L)
        v = w / torch.clamp(torch.linalg.norm(w, dim=-2, keepdim=True), min=1e-20)
    return v[..., 0]


def rows(p, idx):
    """p (..., N, D) at idx (..., H, S) -> (..., H, S, D)."""
    flat = idx.reshape(idx.shape[:-2] + (-1, 1))
    return torch.take_along_dim(p, flat, -2).reshape(idx.shape + p.shape[-1:])


def pick(x, i):
    """x (..., M, *rest) at i (...,) along M."""
    nb = i.dim()
    rest = x.shape[nb + 1:]
    ix = i.reshape(i.shape + (1,) * (1 + len(rest))).expand(i.shape + (1,) + rest)
    return torch.take_along_dim(x, ix, nb).squeeze(nb)


def det3(M):
    return torch.linalg.det(M)


# ------------------------------------------------------- essential matrix
def eight_point(p1, p2, w, project=True):
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, torch.ones_like(x1)], -1)
    E = null_vector_9((A * w[..., None]).transpose(-1, -2) @ A).reshape(p1.shape[:-2] + (3, 3))
    if not project:
        return E
    U, _, Vt = torch.linalg.svd(E)
    return U @ torch.diag_embed(torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
                                .expand(U.shape[:-1])) @ Vt


def sampson(E, p1, p2):
    x1, x2 = homog(p1), homog(p2)
    Ex1 = x1 @ E.transpose(-1, -2)
    Etx2 = x2 @ E
    num = (x2 * Ex1).sum(-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def depths(R, t, p1, p2):
    """Two-view depths (z1, z2) of x2 ~ R x1 + t."""
    f1, f2 = homog(p1), homog(p2)
    Rf1 = f1 @ R.transpose(-1, -2)
    c1 = torch.linalg.cross(Rf1, f2.expand_as(Rf1), dim=-1)
    c2 = torch.linalg.cross(f2.expand_as(Rf1), t[..., None, :].expand_as(Rf1), dim=-1)
    z1 = (c1 * c2).sum(-1) / torch.clamp((c1 * c1).sum(-1), min=1e-12)
    return z1, (z1[..., None] * Rf1 + t[..., None, :])[..., 2]


def count_front(R, t, p1, p2, w):
    z1, z2 = depths(R, t, p1, p2)
    return (((z1 > 0) & (z2 > 0)).float() * w).sum(-1)


def recover_pose(E, p1, p2, w):
    U, _, Vt = torch.linalg.svd(E)
    U = U * torch.sign(det3(U))[..., None, None]
    Vt = Vt * torch.sign(det3(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1, R2, t = U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]
    Rc = torch.stack([R1, R1, R2, R2], -3)
    tc = torch.stack([t, -t, t, -t], -2)
    counts = count_front(Rc, tc, p1[..., None, :, :], p2[..., None, :, :], w[..., None, :])
    best = counts.argmax(-1)
    return pick(Rc, best), pick(tc, best)


# ------------------------------------------------------------ homography
def dlt(p1, p2, w):
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    o, z = torch.ones_like(x1), torch.zeros_like(x1)
    r1 = torch.stack([-x1, -y1, -o, z, z, z, x2 * x1, x2 * y1, x2], -1)
    r2 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], -1)
    A = torch.cat([r1, r2], -2)
    Aw = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)
    return null_vector_9(Aw.transpose(-1, -2) @ A).reshape(p1.shape[:-2] + (3, 3))


def transfer(H, p1, p2):
    Hx = homog(p1) @ H.transpose(-1, -2)
    z = Hx[..., 2]
    z = torch.where(z.abs() < 1e-9, 1e-9, z)
    d = Hx[..., :2] / z[..., None] - p2
    return (d * d).sum(-1)


def homography_ransac(p1, p2, valid, idx, thresh):
    Hs = dlt(rows(p1, idx), rows(p2, idx), torch.ones(idx.shape[-1], device=p1.device))
    inl = (transfer(Hs, p1[..., None, :, :], p2[..., None, :, :]) < thresh).float() * valid[..., None, :].float()
    best = inl.sum(-1).argmax(-1)
    H, mask = pick(Hs, best), pick(inl, best) > 0
    H2 = dlt(p1, p2, mask.float())
    m2 = (transfer(H2, p1, p2) < thresh) & valid
    better = m2.sum(-1) >= mask.sum(-1)
    H = torch.where(better[..., None, None], H2, H)
    mask = torch.where(better[..., None], m2, mask)
    return H, mask, mask.sum(-1)


def homography_motions(H):
    """Faugeras' decomposition of calibrated homographies into 8 motions
    (R (..., 8, 3, 3), unit-free t (..., 8, 3)) and the strength
    (d1 - d3) / d2."""
    U, S, Vt = torch.linalg.svd(H)
    V = Vt.transpose(-1, -2)
    s = det3(U) * det3(V)
    d1, d3 = S[..., 0] / S[..., 1], S[..., 2] / S[..., 1]
    kw = dict(dtype=H.dtype, device=H.device)
    den = torch.clamp(d1 * d1 - d3 * d3, min=1e-9)
    a1 = torch.sqrt(torch.clamp(d1 * d1 - 1.0, min=0.0) / den)
    a3 = torch.sqrt(torch.clamp(1.0 - d3 * d3, min=0.0) / den)
    e1 = torch.tensor([1.0, 1.0, -1.0, -1.0], **kw)
    e3 = torch.tensor([1.0, -1.0, 1.0, -1.0], **kw)
    x1, x3 = e1 * a1[..., None], e3 * a3[..., None]
    zero, one = torch.zeros_like(x1), torch.ones_like(x1)
    cross = torch.sqrt(torch.clamp((d1 * d1 - 1.0) * (1.0 - d3 * d3), min=0.0))
    # d' = +d2
    sth = e1 * e3 * (cross / torch.clamp(d1 + d3, min=1e-9))[..., None]
    cth = ((1.0 + d1 * d3) / torch.clamp(d1 + d3, min=1e-9))[..., None] * one
    Rp = torch.stack([torch.stack([cth, zero, -sth], -1), torch.stack([zero, one, zero], -1),
                      torch.stack([sth, zero, cth], -1)], -2)
    tp = (d1 - d3)[..., None, None] * torch.stack([x1, zero, -x3], -1)
    # d' = -d2
    sph = e1 * e3 * (cross / torch.clamp((d1 - d3).abs(), min=1e-9))[..., None]
    cph = ((d1 * d3 - 1.0) / torch.clamp((d1 - d3).abs(), min=1e-9))[..., None] * one
    Rn = torch.stack([torch.stack([cph, zero, sph], -1), torch.stack([zero, -one, zero], -1),
                      torch.stack([sph, zero, -cph], -1)], -2)
    tn = (d1 + d3)[..., None, None] * torch.stack([x1, zero, x3], -1)
    Rs = s[..., None, None, None] * (U[..., None, :, :] @ torch.cat([Rp, Rn], -3) @ Vt[..., None, :, :])
    ts = (U[..., None, :, :] @ torch.cat([tp, tn], -2)[..., None])[..., 0]
    return Rs, ts, d1 - d3


def plane_motion(H, R_hint, p1, p2, w):
    Rs, ts, strength = homography_motions(H)
    tn = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-9)
    front = count_front(Rs, tn, p1[..., None, :, :], p2[..., None, :, :], w[..., None, :])
    cos = 0.5 * (torch.diagonal(Rs @ R_hint[..., None, :, :].transpose(-1, -2),
                                dim1=-2, dim2=-1).sum(-1) - 1.0)
    k = (front + cos).argmax(-1)
    return pick(Rs, k), pick(tn, k), strength


# ------------------------------------------------------------------ polish
def tangent_basis(t):
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    e1 = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    a = torch.where(t[..., :1].abs() < 0.7, e0, e1)
    b1 = torch.linalg.cross(t, a, dim=-1)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True), min=1e-9)
    return torch.stack([b1, torch.linalg.cross(t, b1, dim=-1)], -1)


def signed_residuals(E, x1, x2):
    Ex1 = x1 @ E.transpose(-1, -2)
    Etx2 = x2 @ E
    num = (x2 * Ex1).sum(-1)
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.sqrt(torch.clamp(den, min=1e-12))


def moved(R, t, B, d):
    Rn = R @ so3_exp(d[..., :3])
    tn = (so3_exp((B @ d[..., 3:, None])[..., 0]) @ t[..., None])[..., 0]
    return Rn, tn


def polish(R, t, p1, p2, w, thresh, iters=8, damping=1e-4):
    """Gauss-Newton on the 5-dof essential manifold, Huber-weighted
    Sampson residuals, a step kept only when it lowers the cost."""
    hd = thresh ** 0.5
    x1, x2 = homog(p1), homog(p2)

    def huber(r):
        return w * torch.clamp(hd / torch.clamp(r.abs(), min=1e-12), max=1.0)

    eye5 = torch.eye(5, dtype=p1.dtype, device=p1.device)
    for _ in range(iters):
        B = tangent_basis(t)

        def res(d):
            Rn, tn = moved(R, t, B, d)
            return signed_residuals(skew(tn) @ Rn, x1, x2)

        zero = torch.zeros(R.shape[:-2] + (5,), dtype=p1.dtype, device=p1.device)
        cols = []
        for k in range(5):
            e = torch.zeros_like(zero)
            e[..., k] = 1.0
            r, dr = jvp(res, (zero,), (e,))
            cols.append(dr)
        J = torch.stack(cols, -1)
        wr = huber(r)
        Jw = J * wr[..., None]
        H = Jw.transpose(-1, -2) @ J + damping * eye5
        g = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]
        step = -torch.linalg.solve(H, g)
        Rn, tn = moved(R, t, B, step)
        tn = tn / torch.clamp(torch.linalg.norm(tn, dim=-1, keepdim=True), min=1e-9)
        r_new = signed_residuals(skew(tn) @ Rn, x1, x2)
        ok = (huber(r_new) * r_new * r_new).sum(-1) <= (wr * r * r).sum(-1)
        R = torch.where(ok[..., None, None], Rn, R)
        t = torch.where(ok[..., None], tn, t)
    return R, t


# ------------------------------------------------------------ the gyro
def _exp_so3(w):
    """Rodrigues' formula: the rotation of the rotation vector w (3,)."""
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * Kx + (1.0 - np.cos(th)) * (Kx @ Kx)


def gyro_pairs(imu_ts, gyro, frame_ts, min_samples=2):
    """The body rotation over each frame pair from the gyro's rates, in
    float64: the product of exp(w dt) over the samples inside (t0, t1],
    the last rate held to t1; returned as the pose change's rotation
    X_cur = R X_prev, i.e. the transpose, in float32 -> (R (F-1, 3, 3),
    ok (F-1,)). A pair with fewer than `min_samples` samples has none."""
    imu_ts, gyro = np.asarray(imu_ts, np.float64), np.asarray(gyro, np.float64)
    frame_ts = np.asarray(frame_ts, np.float64)
    n = max(len(frame_ts) - 1, 0)
    Rs = np.tile(np.eye(3, dtype=np.float32), (n, 1, 1))
    ok = np.zeros(n, bool)
    for i in range(n):
        t0, t1 = frame_ts[i], frame_ts[i + 1]
        lo, hi = np.searchsorted(imu_ts, [t0, t1], side="right")
        if t1 <= t0 or hi - lo < min_samples:
            continue
        D, t = np.eye(3), t0
        for j in range(lo, hi):
            D = D @ _exp_so3(gyro[j] * (imu_ts[j] - t))
            t = imu_ts[j]
        if t1 > t:
            D = D @ _exp_so3(gyro[hi - 1] * (t1 - t))
        Rs[i], ok[i] = D.T.astype(np.float32), True
    return Rs, ok


def compose_lag(R, ok, lag):
    """The rotation and its flag over each window of `lag` consecutive
    pairs, (F-1, 3, 3) -> (F-lag, 3, 3): R_{i+lag-1} ... R_i."""
    n = R.shape[0] + 1 - lag
    Rl, okl = R[:n], ok[:n]
    for s in range(1, lag):
        Rl = R[s:s + n] @ Rl
        okl = okl & ok[s:s + n]
    return Rl, okl


def rotation_deg(A, B):
    """Angle (degrees) of A^T B for rotations (..., 3, 3), in float64:
    atan2 of the skew part's norm and the trace, exact near 0."""
    M = A.double().transpose(-1, -2) @ B.double()
    c = (M.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0) / 2.0
    s = torch.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                     M[..., 1, 0] - M[..., 0, 1]], -1).norm(dim=-1) / 2.0
    return torch.rad2deg(torch.atan2(s, c))


# ----------------------------------------------------------- the pose
def relative_pose(xy1, xy2, valid, K, cfg, draws):
    """RANSAC two-view pose over padded correspondences (..., N, 2):
    -> dict(R, t, mask, ninl, ok). draws: the program's minimal samples,
    {"essential": (..., H, 8), "homography": (..., Hh, 4)} indices."""
    p1, p2 = normalize(xy1, K), normalize(xy2, K)
    focal = 0.5 * (K[0, 0] + K[1, 1])
    thresh = (cfg["inlier_threshold_px"] / focal) ** 2
    idx = draws["essential"]
    Es = eight_point(rows(p1, idx), rows(p2, idx), torch.ones(idx.shape[-1], device=p1.device),
                     project=False)
    inl = (sampson(Es, p1[..., None, :, :], p2[..., None, :, :]) < thresh).float() * valid[..., None, :].float()
    best = inl.sum(-1).argmax(-1)
    U, _, Vt = torch.linalg.svd(pick(Es, best))
    E = U @ torch.diag_embed(torch.tensor([1.0, 1.0, 0.0], device=p1.device).expand(U.shape[:-1])) @ Vt
    mask = pick(inl, best) > 0
    del inl
    if cfg["refine"]:
        E2 = eight_point(p1, p2, mask.float())
        m2 = (sampson(E2, p1, p2) < thresh) & valid
        better = m2.sum(-1) >= mask.sum(-1)
        E = torch.where(better[..., None, None], E2, E)
        mask = torch.where(better[..., None], m2, mask)
    R, t = recover_pose(E, p1, p2, mask.float())
    if cfg["h_fallback"]:
        H, hmask, sh = homography_ransac(p1, p2, valid, draws["homography"], thresh)
        Rh, th, strength = plane_motion(H, R, p1, p2, hmask.float())
        use = (sh.float() >= cfg["h_support_ratio"] * mask.sum(-1).float()) & (strength > 3e-3)
        R = torch.where(use[..., None, None], Rh, R)
        t = torch.where(use[..., None], th, t)
        mfin = (sampson(skew(t) @ R, p1, p2) < thresh) & valid
        mask = torch.where(use[..., None], mfin, mask)
    if cfg["polish_iters"] > 0:
        R, t = polish(R, t, p1, p2, mask.float(), thresh, cfg["polish_iters"])
        mask = (sampson(skew(t) @ R, p1, p2) < thresh) & valid
    ninl = mask.sum(-1)
    z1, z2 = depths(R, t, p1, p2)
    front = ((z1 > 0) & (z2 > 0) & mask).float().sum(-1)
    cheir = front > 0.35 * ninl
    if cfg["rot_only_rescue"]:
        r1 = homog(p1) / torch.linalg.norm(homog(p1), dim=-1, keepdim=True)
        r2 = homog(p2) / torch.linalg.norm(homog(p2), dim=-1, keepdim=True)
        cosang = torch.clamp(((r1 @ R.transpose(-1, -2)) * r2).sum(-1), -1.0, 1.0)
        nrot = ((2.0 * (1.0 - cosang) < thresh) & mask).float().sum(-1)
        cheir = cheir | ((nrot > cfg["min_inliers"]) & (nrot >= cfg["rot_only_frac"] * ninl.float()))
    return dict(R=R, t=t, mask=mask, ninl=ninl, ok=(ninl > cfg["min_inliers"]) & cheir)


def translation_under(R, p1, p2, w, thresh, valid):
    """Unit t with R known: the null vector of the 3x3 normal matrix of
    (x2 x R x1) . t = 0, refreshed twice against the Sampson gate, its
    sign by cheirality -> (t, mask)."""
    x1, x2 = homog(p1), homog(p2)
    c = torch.linalg.cross(x2, x1 @ R.transpose(-1, -2), dim=-1)
    ww = torch.where(w.sum(-1, keepdim=True) >= 3.0, w, valid.float())
    for _ in range(2):
        t = null_vector((c * ww[..., None]).transpose(-1, -2) @ c)
        ww = ((sampson(skew(t) @ R, p1, p2) < thresh) & valid).float()
    flip = count_front(R, -t, p1, p2, ww) > count_front(R, t, p1, p2, ww)
    t = torch.where(flip[..., None], -t, t)
    return t, (sampson(skew(t) @ R, p1, p2) < thresh) & valid


def fused_pose(xy1, xy2, valid, K, cfg, draws, gyro_R, has_gyro):
    """relative_pose, then for pairs with a gyro rotation that rotation
    and the translation re-solved under it."""
    d = relative_pose(xy1, xy2, valid, K, cfg, draws)
    p1, p2 = normalize(xy1, K), normalize(xy2, K)
    focal = 0.5 * (K[0, 0] + K[1, 1])
    thresh = (cfg["inlier_threshold_px"] / focal) ** 2
    tg, mg = translation_under(gyro_R, p1, p2, d["mask"].float(), thresh, valid)
    ng = mg.sum(-1)
    g = has_gyro
    return dict(R=torch.where(g[..., None, None], gyro_R, d["R"]),
                t=torch.where(g[..., None], tg, d["t"]),
                mask=torch.where(g[..., None], mg, d["mask"]),
                ninl=torch.where(g, ng, d["ninl"]),
                ok=torch.where(g, ng > cfg["min_inliers"], d["ok"]))


def pins(pose, xy1, xy2, valid, K, scene_depth):
    """The scene-depth pin of each pair from its inliers' triangulated
    depths -> (scale, ok)."""
    z1, z2 = depths(pose["R"], pose["t"], normalize(xy1, K), normalize(xy2, K))
    good = pose["mask"] & valid & (z1 > 1e-3) & (z1 < 1e4) & (z2 > 1e-3) & (z2 < 1e4)
    cnt = good.float().sum(-1)
    mean = torch.where(good, torch.log(torch.clamp(z1, 1e-4, 1e5)), 0.0).sum(-1) / torch.clamp(cnt, min=1.0)
    ok = cnt >= 20
    scale = torch.where(ok, scene_depth / torch.clamp(torch.exp(mean), min=1e-3), 1.0)
    return torch.clamp(scale, 0.01, 100.0), ok
