"""Essential-matrix RANSAC, pose recovery and depth pins (counterpart of
the JAX package's ops/epipolar.py).

A fixed budget of `num_hypotheses` 8-point solves, batched over the
hypothesis axis, Sampson scoring over all matches, a winner reduction,
a refit, the dominant-plane homography rescue and a Sampson Gauss-Newton
polish, step for step as the reference.

Sampling: the reference draws its minimal samples with jax.random, which
torch cannot reproduce, so the sampler is an argument: a callable
`sampler(valid (..., N), num_hypotheses, sample_size, stage) ->
(..., H, S) int64 indices`, with stage "essential" or "homography".
`TorchSampler` is the default; a test can pass one that makes the
reference's draws.

Every function takes any leading batch axes (points (..., N, 2), masks
(..., N), matrices (..., 3, 3)) and gives for a batch what it gives pair
by pair: the chunked evaluator runs all pairs of a chunk in one call, so
the number of device launches stays that of one pair.

Conventions: E satisfies x2^T E x1 = 0 for normalized coords; (R, t)
place camera 2 relative to camera 1: X_cam2 = R @ X_cam1 + t, |t| = 1.
"""

from __future__ import annotations

import torch

from aria_slam_tpu_torch.config import RansacConfig
from aria_slam_tpu_torch.core import lie
from aria_slam_tpu_torch.core.autodiff import row_jacobian
from aria_slam_tpu_torch.core.types import PoseDelta
from aria_slam_tpu_torch.ops.linalg import (
    cholesky_solve, det3, eigh3, smallest_eigvec, svd3,
)


class TorchSampler:
    """Uniform draws with replacement over the valid correspondences
    (over all slots when none is valid), from an explicit
    torch.Generator on the data's device, for all leading batch axes of
    `valid` in one call. The same distribution as the reference's
    categorical draw over masked logits."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        batch = valid.shape[:-1]
        w = valid.float()
        w = torch.where(w.sum(-1, keepdim=True) > 0, w, torch.ones_like(w))
        cdf = torch.cumsum(w, -1)
        u = torch.rand(batch + (num_hypotheses * sample_size,), generator=self.generator,
                       device=valid.device) * cdf[..., -1:]
        idx = torch.searchsorted(cdf, u, right=True).clamp(max=valid.shape[-1] - 1)
        return idx.reshape(batch + (num_hypotheses, sample_size))


def normalize_points(uv: torch.Tensor, K: torch.Tensor) -> torch.Tensor:
    """Pixel (N, 2) -> normalized camera coords (N, 2)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)


def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], -1)


def _pick(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (..., M, *rest) at idx (...,) along M -> (..., *rest): the batched
    form of x[idx]."""
    nb = idx.dim()
    rest = x.shape[nb + 1:]
    ix = idx.reshape(idx.shape + (1,) * (1 + len(rest))).expand(idx.shape + (1,) + rest)
    return torch.take_along_dim(x, ix, nb).squeeze(nb)


def _rows(p: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """p (..., N, D) at idx (..., H, S) along N -> (..., H, S, D): the
    batched form of p[idx]."""
    flat = idx.reshape(idx.shape[:-2] + (-1, 1))
    return torch.take_along_dim(p, flat, -2).reshape(idx.shape + p.shape[-1:])


def smallest_eigvec_9(M: torch.Tensor, iters: int = 3) -> torch.Tensor:
    """Unit eigenvector of the smallest eigenvalue of symmetric PSD
    (..., 9, 9), by regularised inverse iteration (ops/linalg.py)."""
    return smallest_eigvec(M, iters)


def _normal_matrix(p1, p2, w):
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    # row: [x2x1, x2y1, x2, y2x1, y2y1, y2, x1, y1, 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], -1)
    return (A * w[..., None]).transpose(-1, -2) @ A  # (..., 9, 9)


def project_to_essential(E: torch.Tensor) -> torch.Tensor:
    """Force singular values to (1, 1, 0)."""
    U, _, Vt = svd3(E)
    S_proj = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * S_proj) @ Vt


def eight_point(p1, p2, w, project: bool = True) -> torch.Tensor:
    """Weighted 8-point estimate of E from normalized coords (batched over
    leading axes). project=False returns the raw nullspace estimate."""
    E = smallest_eigvec_9(_normal_matrix(p1, p2, w)).reshape(p1.shape[:-2] + (3, 3))
    return project_to_essential(E) if project else E


def sampson_error(E, p1, p2) -> torch.Tensor:
    """Squared Sampson distance (..., N) in normalized coords; E may
    carry leading batch axes."""
    x1 = _homog(p1)
    x2 = _homog(p2)
    Ex1 = x1 @ E.transpose(-1, -2)   # rows = E @ x1
    Etx2 = x2 @ E                    # rows = E^T @ x2
    num = torch.sum(x2 * Ex1, -1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def triangulate_depths(R, t, p1, p2):
    """Two-view depths (z1, z2), each (..., N), for x2 ~ R x1 + t;
    R (..., 3, 3) and t (..., 3) may carry leading batch axes."""
    f1 = _homog(p1)
    f2 = _homog(p2)
    Rf1 = f1 @ R.transpose(-1, -2)
    c1 = lie.cross(Rf1, f2)
    c2 = lie.cross(f2, t[..., None, :])
    z1 = torch.sum(c1 * c2, -1) / torch.clamp(torch.sum(c1 * c1, -1), min=1e-12)
    pt2 = z1[..., None] * Rf1 + t[..., None, :]
    return z1, pt2[..., 2]


def decompose_essential(E: torch.Tensor):
    """E -> (R1, R2, t) candidate factors with proper rotations."""
    U, _, Vt = svd3(E)
    U = U * torch.sign(det3(U))[..., None, None]
    Vt = Vt * torch.sign(det3(Vt))[..., None, None]
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    return U @ W @ Vt, U @ W.T @ Vt, U[..., :, 2]


def _count_front(R, t, p1, p2, weights):
    z1, z2 = triangulate_depths(R, t, p1, p2)
    return torch.sum(((z1 > 0) & (z2 > 0)).float() * weights, -1)


def recover_pose(E, p1, p2, weights):
    """The chirality candidate with most weighted points in front of both
    cameras. weights: (..., N) inlier mask."""
    R1, R2, t = decompose_essential(E)
    cands_R = torch.stack([R1, R1, R2, R2], -3)   # (..., 4, 3, 3)
    cands_t = torch.stack([t, -t, t, -t], -2)     # (..., 4, 3)
    counts = _count_front(cands_R, cands_t, p1[..., None, :, :], p2[..., None, :, :],
                          weights[..., None, :])
    best = torch.argmax(counts, -1)
    return _pick(cands_R, best), _pick(cands_t, best), _pick(counts, best)


def lax_skew_E(R, t):
    """E = [t]x R."""
    return lie.skew(t) @ R


def translation_given_rotation(R, p1, p2, w, refine_rounds: int = 1,
                               thresh_sq=None, valid=None):
    """Unit translation with the rotation known: the smallest eigenvector
    of the 3x3 normal matrix of (x2 x R x1) . t = 0, refreshed against
    the Sampson gate. Returns (t_unit, inlier_mask)."""
    x1 = _homog(p1)
    x2 = _homog(p2)
    c = lie.cross(x2, x1 @ R.transpose(-1, -2))
    # degenerate seed: (near-)empty weights fall back to every valid slot
    fb = valid.to(p1.dtype) if valid is not None else torch.ones_like(w)
    ww = torch.where(torch.sum(w, -1, keepdim=True) >= 3.0, w, fb)

    t = None
    for _ in range(max(1, refine_rounds + 1)):
        M = (c * ww[..., None]).transpose(-1, -2) @ c
        _, vecs = eigh3(M)
        t = vecs[..., :, 0]
        if thresh_sq is not None and valid is not None:
            errs = sampson_error(lax_skew_E(R, t), p1, p2)
            ww = ((errs < thresh_sq) & valid).to(p1.dtype)

    # cheirality: the sign that puts points in front
    flip = _count_front(R, -t, p1, p2, ww) > _count_front(R, t, p1, p2, ww)
    t = torch.where(flip[..., None], -t, t)
    if thresh_sq is not None and valid is not None:
        errs = sampson_error(lax_skew_E(R, t), p1, p2)
        return t, (errs < thresh_sq) & valid
    return t, w > 0


def _tangent_basis(t):
    """(..., 3, 2) orthonormal basis of the plane normal to unit t (..., 3)."""
    e0 = torch.tensor([1.0, 0.0, 0.0], dtype=t.dtype, device=t.device)
    e1 = torch.tensor([0.0, 1.0, 0.0], dtype=t.dtype, device=t.device)
    a = torch.where(torch.abs(t[..., :1]) < 0.7, e0, e1)
    b1 = lie.cross(t, a)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True), min=1e-9)
    b2 = lie.cross(t, b1)
    return torch.stack([b1, b2], -1)


def polish_pose_sampson(R, t, p1, p2, w, thresh, iters: int = 8,
                        damping: float = 1e-4):
    """Gauss-Newton refinement of (R, t) on the 5-dof essential manifold
    minimising Huber-weighted Sampson error; Jacobians by autodiff
    (core/autodiff.py), a diverging step is rejected."""
    huber_delta = torch.sqrt(torch.as_tensor(thresh, dtype=p1.dtype, device=p1.device))
    x1 = _homog(p1)[..., None]   # (..., N, 3, 1)
    x2 = _homog(p2)[..., None]
    eye5 = torch.eye(5, dtype=p1.dtype, device=p1.device)

    def signed_residuals(E):  # one E per correspondence (..., N, 3, 3), or (..., 1, 3, 3)
        Ex1 = (E @ x1)[..., 0]
        Etx2 = (E.transpose(-1, -2) @ x2)[..., 0]
        num = torch.sum(x2[..., 0] * Ex1, -1)
        den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
        return num / torch.sqrt(torch.clamp(den, min=1e-12))

    def huber(r):
        return w * torch.clamp(huber_delta / torch.clamp(torch.abs(r), min=1e-12), max=1.0)

    zero = torch.zeros(p1.shape[:-1] + (5,), dtype=p1.dtype, device=p1.device)
    for _ in range(iters):
        B = _tangent_basis(t)

        def rows(delta, R_=R, t_=t, B_=B):  # (..., N, 1, 5) per-correspondence steps
            d = delta[..., 0, :]
            Rn = R_[..., None, :, :] @ lie.so3_exp(d[..., :3])
            tn = (lie.so3_exp(d[..., 3:] @ B_.transpose(-1, -2))
                  @ t_[..., None, :, None])[..., 0]
            return signed_residuals(lie.skew(tn) @ Rn)[..., None, None]

        r = signed_residuals((lie.skew(t) @ R)[..., None, :, :])
        J = row_jacobian(rows, zero, 1)[..., 0, :]       # (..., N, 5)
        wr = huber(r)
        Jw = J * wr[..., None]
        H = Jw.transpose(-1, -2) @ J + damping * eye5
        g = (Jw.transpose(-1, -2) @ r[..., None])[..., 0]
        delta = -cholesky_solve(H, g)
        Rn = R @ lie.so3_exp(delta[..., :3])
        tn = (lie.so3_exp((B @ delta[..., 3:, None])[..., 0]) @ t[..., None])[..., 0]
        tn = tn / torch.clamp(torch.linalg.norm(tn, dim=-1, keepdim=True), min=1e-9)
        c_old = torch.sum(wr * r * r, -1)
        r_new = signed_residuals((lie.skew(tn) @ Rn)[..., None, :, :])
        c_new = torch.sum(huber(r_new) * r_new * r_new, -1)
        ok = c_new <= c_old
        R = torch.where(ok[..., None, None], Rn, R)
        t = torch.where(ok[..., None], tn, t)
    return R, t


def estimate_relative_pose(xy1, xy2, valid, K, cfg: RansacConfig, sampler) -> PoseDelta:
    """Full RANSAC pipeline over padded correspondences: slot i of xy1
    matches slot i of xy2 (both (..., N, 2)), valid (..., N) masks the
    live slots. Leading axes are independent pairs solved together."""
    from aria_slam_tpu_torch.ops import homography as homog

    p1 = normalize_points(xy1, K)
    p2 = normalize_points(xy2, K)
    focal = 0.5 * (K[0, 0] + K[1, 1])
    thresh_sq = (cfg.inlier_threshold_px / focal) ** 2
    validf = valid.float()

    idx = sampler(valid, cfg.num_hypotheses, cfg.sample_size, "essential")  # (..., H, S)
    ones = torch.ones(cfg.sample_size, dtype=p1.dtype, device=p1.device)
    # unprojected nullspace estimates: only the winner is projected
    Es = eight_point(_rows(p1, idx), _rows(p2, idx), ones, project=False)  # (..., H, 3, 3)
    inl = ((sampson_error(Es, p1[..., None, :, :], p2[..., None, :, :]) < thresh_sq).float()
           * validf[..., None, :])
    best_h = torch.argmax(inl.sum(-1), -1)
    E_best = project_to_essential(_pick(Es, best_h))
    inlier_mask = _pick(inl, best_h) > 0
    del inl  # (..., H, N): the largest tensor of the call

    if cfg.refine:
        E_ref = eight_point(p1, p2, inlier_mask.to(p1.dtype))
        inl_ref = (sampson_error(E_ref, p1, p2) < thresh_sq) & valid
        better = inl_ref.sum(-1) >= inlier_mask.sum(-1)
        E_best = torch.where(better[..., None, None], E_ref, E_best)
        inlier_mask = torch.where(better[..., None], inl_ref, inlier_mask)

    R, t, _ = recover_pose(E_best, p1, p2, inlier_mask.to(p1.dtype))

    if cfg.h_fallback:
        # dominant-plane rescue (ops/homography.py)
        Hm, h_mask, s_h = homog.estimate_homography(
            p1, p2, valid, sampler, cfg.h_hypotheses, thresh_sq)
        R_h, t_h, strength = homog.best_h_motion(Hm, R, p1, p2, h_mask.to(p1.dtype))
        s_e = inlier_mask.to(torch.int32).sum(-1)
        use_h = ((s_h.float() >= cfg.h_support_ratio * s_e.float())
                 & (strength > 3e-3))
        R = torch.where(use_h[..., None, None], R_h, R)
        t = torch.where(use_h[..., None], t_h, t)
        mask_fin = (sampson_error(lax_skew_E(R, t), p1, p2) < thresh_sq) & valid
        inlier_mask = torch.where(use_h[..., None], mask_fin, inlier_mask)

    if cfg.polish_iters > 0:
        R, t = polish_pose_sampson(R, t, p1, p2, inlier_mask.to(p1.dtype),
                                   thresh_sq, iters=cfg.polish_iters)
        inlier_mask = (sampson_error(lax_skew_E(R, t), p1, p2) < thresh_sq) & valid

    num_inliers = inlier_mask.to(torch.int32).sum(-1)
    z1f, z2f = triangulate_depths(R, t, p1, p2)
    front = ((z1f > 0) & (z2f > 0) & inlier_mask).float().sum(-1)
    # 0.35, not 0.5: at near-zero parallax depth signs are noise for many
    # points; a wrong-sign translation puts nearly everything behind
    cheirality_ok = front > 0.35 * num_inliers
    if cfg.rot_only_rescue:
        # rotation-only regime: cheirality carries no information there
        r1 = _homog(p1)
        r2 = _homog(p2)
        r1 = r1 / torch.clamp(torch.linalg.norm(r1, dim=-1, keepdim=True), min=1e-9)
        r2 = r2 / torch.clamp(torch.linalg.norm(r2, dim=-1, keepdim=True), min=1e-9)
        cosang = torch.clamp(torch.sum((r1 @ R.transpose(-1, -2)) * r2, -1), -1.0, 1.0)
        rot_inl = (2.0 * (1.0 - cosang) < thresh_sq) & inlier_mask
        n_rot = rot_inl.float().sum(-1)
        rot_only = ((n_rot > cfg.min_inliers)
                    & (n_rot >= cfg.rot_only_frac * num_inliers.float()))
        cheirality_ok = cheirality_ok | rot_only
    success = (num_inliers > cfg.min_inliers) & cheirality_ok
    return PoseDelta(R=R, t=t, num_inliers=num_inliers, inlier_mask=inlier_mask,
                     success=success)


def pair_depths(delta: PoseDelta, xy1, xy2, valid, K):
    """Per-correspondence two-view depths under the pair's unit-|t| scale
    -> (z1, z2, good)."""
    p1 = normalize_points(xy1, K)
    p2 = normalize_points(xy2, K)
    z1, z2 = triangulate_depths(delta.R, delta.t, p1, p2)
    good = (delta.inlier_mask & valid
            & (z1 > 1e-3) & (z1 < 1e4) & (z2 > 1e-3) & (z2 < 1e4))
    return z1, z2, good


def tfree_parallax_depths(delta: PoseDelta, xy1, xy2, valid, K, sigma_px: float):
    """Translation-direction-robust camera-1 z-depths under the pair's
    unit-|t| scale -> (z, good): range sin(alpha) / beta with the
    rotation-compensated ray displacement beta debiased by the keypoint
    noise, converted to z by the ray's z component."""
    p1 = normalize_points(xy1, K)
    p2 = normalize_points(xy2, K)
    f1 = _homog(p1)
    f2 = _homog(p2)
    d1 = f1 / torch.clamp(torch.linalg.norm(f1, dim=-1, keepdim=True), min=1e-9)
    d2p = f2 @ delta.R  # rows: R^T f2
    d2p = d2p / torch.clamp(torch.linalg.norm(d2p, dim=-1, keepdim=True), min=1e-9)
    u = d2p - torch.sum(d2p * d1, -1, keepdim=True) * d1
    usq = torch.sum(u * u, -1)
    focal = 0.5 * (K[0, 0] + K[1, 1])
    sig2 = (sigma_px / focal) ** 2
    beta = torch.sqrt(torch.maximum(usq - 2.0 * sig2, 0.05 * usq))
    b = -(delta.t[..., None, :] @ delta.R)  # (..., 1, 3) baseline direction in the prev frame
    b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=1e-12)
    bp = b - torch.sum(b * d1, -1, keepdim=True) * d1
    sin_alpha = torch.linalg.norm(bp, dim=-1)
    z = sin_alpha / torch.clamp(beta, min=1e-9) * d1[..., 2]
    good = delta.inlier_mask & valid & (z > 1e-3) & (z < 1e4)
    return z, good


def pin_depths(delta: PoseDelta, xy1, xy2, valid, K,
               estimator: str = "triangulated", sigma_px: float = 0.55):
    """Depth statistic feeding the scene-depth pin
    (PipelineConfig.vo_pin_estimator)."""
    if estimator == "tfree_parallax":
        return tfree_parallax_depths(delta, xy1, xy2, valid, K, sigma_px)
    z1, _, good = pair_depths(delta, xy1, xy2, valid, K)
    return z1, good


def geomean_ratio(num, den, mask):
    """Masked geometric mean of num/den -> (ratio, count)."""
    cnt = mask.float().sum(-1)
    r = torch.log(torch.clamp(num, 1e-4, 1e5)) - torch.log(torch.clamp(den, 1e-4, 1e5))
    mean = torch.where(mask, r, 0.0).sum(-1) / torch.clamp(cnt, min=1.0)
    return torch.exp(mean), cnt


def masked_log_median(z, mask, lo: float = -6.9, hi: float = 9.2, bins: int = 256):
    """Approximate masked median of z in log space over all elements ->
    (median, count): a 256-bin histogram of log z, its cumulative sum and
    linear interpolation inside the median's bin, as the reference (no
    sort). The counts are whole numbers in float32, so the histogram is
    exact in any summation order."""
    lz = torch.clamp(torch.log(torch.clamp(z, 1e-9, 1e9)), lo, hi)
    idx = torch.clamp(((lz - lo) * (bins / (hi - lo))).to(torch.int64), 0, bins - 1)
    h = torch.zeros((bins,), dtype=torch.float32, device=z.device).index_add_(
        0, idx.reshape(-1), mask.reshape(-1).float())
    c = torch.cumsum(h, 0)
    tot = c[-1]
    half = 0.5 * tot
    k = torch.clamp((c < half).sum(), 0, bins - 1)
    prev = torch.where(k > 0, c[torch.clamp(k - 1, min=0)], 0.0)
    frac = torch.clamp((half - prev) / torch.clamp(h[k], min=1e-6), 0.0, 1.0)
    med = lo + (k.float() + frac) * ((hi - lo) / bins)
    return torch.exp(med), tot


def pin_scale(z, mask, scene_depth: float, min_count: int = 20):
    """Scale pinning the masked geometric-mean depth to scene_depth ->
    (scale, ok)."""
    geo, cnt = geomean_ratio(z, torch.ones_like(z), mask)
    ok = cnt >= min_count
    scale = torch.where(ok, scene_depth / torch.clamp(geo, min=1e-3), 1.0)
    return torch.clamp(scale, 0.01, 100.0), ok


def mean_parallax_deg(delta: PoseDelta, xy1, xy2, valid, K):
    """Rotation-compensated mean ray parallax in degrees over the inliers
    -> (parallax_deg, count). Below about 0.5 degrees the essential
    translation is noise: a zero-baseline revisit verifies with a good
    rotation and a meaningless unit t."""
    f1 = _homog(normalize_points(xy1, K))
    f2 = _homog(normalize_points(xy2, K))
    rf = f1 @ delta.R.transpose(-1, -2)  # frame-1 rays expressed in frame 2
    cos = torch.sum(rf * f2, -1) / torch.clamp(
        torch.linalg.norm(rf, dim=-1) * torch.linalg.norm(f2, dim=-1), min=1e-9)
    ang = torch.rad2deg(torch.arccos(torch.clamp(cos, -1.0, 1.0)))
    good = delta.inlier_mask & valid
    cnt = good.float().sum(-1)
    return torch.where(good, ang, 0.0).sum(-1) / torch.clamp(cnt, min=1.0), cnt


def parallax_t_weight(parallax_deg, full_at_deg: float = 1.0):
    """Translation confidence in [0, 1]: 0 below 0.2 degrees of mean
    parallax, ramping to 1 at `full_at_deg`."""
    lo = 0.2
    return torch.clamp((parallax_deg - lo) / max(full_at_deg - lo, 1e-6), 0.0, 1.0)


def estimate_pose_gyro_fused(xy_prev, xy_cur, valid, K, cfg: RansacConfig,
                             sampler, gyro_R, has_gyro, in_thresh_sq) -> PoseDelta:
    """RANSAC two-view pose; where an integrated-gyro rotation is
    available (has_gyro), the rotation is replaced by the gyro's and the
    translation re-solved linearly under it, re-gating the inliers."""
    delta = estimate_relative_pose(xy_prev, xy_cur, valid, K, cfg, sampler)
    t_g, mask_g = translation_given_rotation(
        gyro_R, normalize_points(xy_prev, K), normalize_points(xy_cur, K),
        delta.inlier_mask.float(), thresh_sq=in_thresh_sq, valid=valid)
    ninl_g = mask_g.to(torch.int32).sum(-1)
    return delta.replace(
        R=torch.where(has_gyro[..., None, None], gyro_R, delta.R),
        t=torch.where(has_gyro[..., None], t_g, delta.t),
        inlier_mask=torch.where(has_gyro[..., None], mask_g, delta.inlier_mask),
        num_inliers=torch.where(has_gyro, ninl_g, delta.num_inliers),
        success=torch.where(has_gyro, ninl_g > cfg.min_inliers, delta.success),
    )
