"""Chunk-local multiview bundle adjustment, joint Schur form (counterpart
of the JAX package's backend/chunk_ba.py).

Chained two-view VO never reconciles the geometry of overlapping pairs;
this module refines all poses of a chunk against multi-frame feature
tracks, as fixed-shape batched linear algebra:

  1. tracks:      a loop over the chunk's pairs links epipolar-gated
                  matches into feature tracks (landmark ids).
  2. triangulate: every landmark in closed form from all its observations
                  (world-frame midpoint: a 3x3 solve per landmark).
  3. joint step:  Schur-complement Gauss-Newton on all poses with the
                  landmarks' optimal response folded in; the landmark
                  blocks are batched 3x3 inverses and the Schur cross
                  term is one matmul Z^T Z (see _joint_step).
  4. repeat (2)-(3) with a fixed-shape backtracking line search.

The per-landmark accumulations are index_add_ sums; on a CUDA device
their order of summation is not fixed, so two runs agree to float32
rounding, not bit for bit.

Robustness: Huber weights on the pixel residual, a hard gate for gross
outliers, positive-depth masking, diagonal damping, and a weak twist
prior toward the initial (scale-chained) poses that anchors the
monocular gauge the reprojection cost cannot see.
"""

from __future__ import annotations

import torch

from aria_slam_tpu_torch.config import ChunkBaConfig
from aria_slam_tpu_torch.core import lie
from aria_slam_tpu_torch.ops.epipolar import masked_log_median
from aria_slam_tpu_torch.ops.linalg import cholesky_solve, cholesky_unrolled, inv_psd


def build_tracks(midx, cinl, num_kp):
    """Link per-pair matches into feature tracks.

    midx: (C, N) integer match target: current-frame slot k of pair i
          matched prev-frame slot midx[i, k] (frames i+1 -> i).
    cinl: (C, N) bool: match valid and an inlier of its pair.
    Returns ids (C+1, N) int64 landmark ids in [0, (C+1)*N): a track
    keeps the id of its first observation (frame*N + slot).

    Two current-frame slots can point at the same prev slot; a
    scatter-min per pair keeps one winner per prev slot (the lowest
    current slot), losers start fresh tracks. The losers' and the
    non-inliers' updates carry the value N, above every slot, so they
    never win.
    """
    c, n = midx.shape
    slots = torch.arange(n, device=midx.device)
    prev = slots
    ids = [prev]
    for i in range(c):
        mi = midx[i].long()
        ok = cinl[i]
        win = torch.full((n,), n, dtype=torch.int64, device=midx.device).scatter_reduce(
            0, mi, torch.where(ok, slots, n), "amin", include_self=True)
        keep = ok & (win[mi] == slots)
        prev = torch.where(keep, prev[mi], (i + 1) * n + slots)
        ids.append(prev)
    return torch.stack(ids)


def _segment_sum(values, flat_ids, num_l):
    """Sum rows of `values` (M, ...) into `num_l` landmark rows."""
    return torch.zeros((num_l,) + values.shape[1:], dtype=values.dtype,
                       device=values.device).index_add_(0, flat_ids, values)


def _cam_rays_world(poses, fxy, K):
    """Unit ray directions in the world frame and camera centres.

    poses: (F, 4, 4) world-from-camera; fxy: (F, N, 2) undistorted pixel
    keypoints. Returns d (F, N, 3) unit, c (F, 3)."""
    x = (fxy[..., 0] - K[0, 2]) / K[0, 0]
    y = (fxy[..., 1] - K[1, 2]) / K[1, 1]
    rays_cam = torch.stack([x, y, torch.ones_like(x)], -1)
    d = torch.einsum("fab,fnb->fna", poses[:, :3, :3], rays_cam)
    d = d / torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-9)
    return d, poses[:, :3, 3]


def triangulate_tracks(poses, fxy, obs_w, ids, K, num_landmarks):
    """Closed-form multiview midpoint triangulation of every track.

    Each observation contributes (I - d d^T) to its landmark's 3x3 normal
    matrix (least squared point-to-ray distances). obs_w: (F, N) float32
    observation weights (0 = ignore). Returns X (L, 3) world points and
    cnt (L,), the summed weights."""
    d, c = _cam_rays_world(poses, fxy, K)
    eye = torch.eye(3, dtype=torch.float32, device=poses.device)
    M = (eye - d[..., :, None] * d[..., None, :]) * obs_w[..., None, None]   # (F, N, 3, 3)
    Mc = torch.einsum("fnab,fb->fna", M, c)

    flat = ids.reshape(-1)
    A = _segment_sum(M.reshape(-1, 3, 3), flat, num_landmarks)
    b = _segment_sum(Mc.reshape(-1, 3), flat, num_landmarks)
    cnt = _segment_sum(obs_w.reshape(-1), flat, num_landmarks)
    # damping keeps single-observation and degenerate tracks finite; cnt
    # masks them out of the pose step anyway
    return cholesky_solve(A + 1e-5 * eye, b), cnt


def _project(poses, X, K):
    """Project world points into each observing camera.

    poses (..., F, 4, 4) world-from-camera, X (F, N, 3) world points per
    observation slot. Returns uv (..., F, N, 2), camera-frame depth z
    (..., F, N) and Xc (..., F, N, 3)."""
    R = poses[..., :3, :3]
    t = poses[..., :3, 3]
    Xc = torch.einsum("...fba,...fnb->...fna", R, X - t[..., None, :])   # R^T (X - t)
    z = Xc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = K[0, 0] * Xc[..., 0] / zs + K[0, 2]
    v = K[1, 1] * Xc[..., 1] / zs + K[1, 2]
    return torch.stack([u, v], -1), z, Xc


def _residual_blocks(poses, X_obs, fxy, w_obs, K, cfg: ChunkBaConfig):
    """Residuals r (F, N, 2), robust weights w (F, N), dproj/dXc P
    (F, N, 2, 3) and the pose Jacobian J = P [-I | skew(Xc)] (F, N, 2, 6)
    for the right perturbation T <- T exp(xi), xi = [rho, phi]."""
    uv, z, Xc = _project(poses, X_obs, K)
    r = uv - fxy
    rn = torch.linalg.norm(r, dim=-1)
    huber = torch.clamp(cfg.huber_px / torch.clamp(rn, min=1e-9), max=1.0)
    w = w_obs * huber * (z > cfg.min_depth) * (rn < cfg.gate_px)

    fx, fy = K[0, 0], K[1, 1]
    zs = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    zero = torch.zeros_like(z)
    P = torch.stack([
        torch.stack([fx / zs, zero, -fx * Xc[..., 0] / zs**2], -1),
        torch.stack([zero, fy / zs, -fy * Xc[..., 1] / zs**2], -1),
    ], -2)
    sk = lie.skew(Xc)
    eye3 = torch.eye(3, dtype=torch.float32, device=poses.device).expand(sk.shape)
    J = P @ torch.cat([-eye3, sk], -1)
    return r, w, P, J


def _prior_twist(poses_init, poses):
    return lie.se3_log(lie.se3_inverse(poses_init) @ poses)


def _joint_step(poses, poses_init, ids, fxy, w_obs, K, num_l,
                cfg: ChunkBaConfig, rot_scale=1.0):
    """One joint Gauss-Newton step on poses and landmarks via the Schur
    complement. With landmarks triangulated from the current (wrong)
    poses the reconstruction is nearly self-consistent and block-
    coordinate descent barely moves; the reduced camera system moves the
    poses with the landmarks' optimal response folded in.

    The landmark blocks H_ll are batched 3x3 inverses; the Schur cross
    term sum_l T_l H_ll^-1 T_l^T is one matmul Z^T Z with Z (3L, 6F)
    built by a per-frame scatter; the reduced system is a single dense
    (6F, 6F) solve."""
    f = poses.shape[0]
    dev = poses.device
    f32 = dict(dtype=torch.float32, device=dev)
    X, _ = triangulate_tracks(poses, fxy, w_obs, ids, K, num_l)
    X_obs = X[ids]                                               # (F, N, 3)
    r, w, P, B = _residual_blocks(poses, X_obs, fxy, w_obs, K, cfg)
    # rot_scale = 0 freezes rotations (gyro-backed chains)
    rmask = torch.cat([torch.ones(3, **f32),
                       torch.as_tensor(rot_scale, **f32) * torch.ones(3, **f32)])
    B = B * rmask
    A = torch.einsum("fnab,fcb->fnac", P, poses[:, :3, :3])      # landmark (2, 3): P R^T

    wB = B * w[..., None, None]
    wA = A * w[..., None, None]
    # landmark normal blocks and gradients (scatter over track ids)
    flat = ids.reshape(-1)
    H_ll = _segment_sum(torch.einsum("fnra,fnrb->fnab", wA, A).reshape(-1, 3, 3), flat, num_l)
    g_l = _segment_sum(torch.einsum("fnra,fnr->fna", wA, r).reshape(-1, 3), flat, num_l)
    # trace-relative damping: H_ll entries span ~1e0..1e7
    tr = torch.diagonal(H_ll, dim1=-2, dim2=-1).sum(-1)[:, None, None] / 3.0
    H_ll = H_ll + (cfg.damping * tr + 1e-5) * torch.eye(3, **f32)
    C = inv_psd(H_ll)                                            # (L, 3, 3)
    M = cholesky_unrolled(C)                                     # C = M M^T

    # pose blocks
    H_pp = torch.einsum("fnra,fnrb->fab", wB, B)                 # (F, 6, 6)
    g_p = torch.einsum("fnra,fnr->fa", wB, r)                    # (F, 6)
    H_pp = H_pp + cfg.prior_weight * torch.eye(6, **f32)
    g_p = g_p + cfg.prior_weight * _prior_twist(poses_init, poses)

    # Schur cross term via Z^T Z: G_i[l] = sum_obs B^T w A, Z = G M
    BtA = torch.einsum("fnra,fnrb->fnab", wB, A)                 # (F, N, 6, 3)
    rows = (torch.arange(f, device=dev)[:, None] * num_l + ids).reshape(-1)
    G = _segment_sum(BtA.reshape(-1, 6, 3), rows, f * num_l).reshape(f, num_l, 6, 3)
    Gh = torch.einsum("flab,lbc->flac", G, M)                    # (F, L, 6, 3)
    del G
    Z = Gh.permute(1, 3, 0, 2).reshape(num_l * 3, f * 6)         # (3L, 6F)
    del Gh
    S = torch.zeros((f, 6, f, 6), **f32)
    fi = torch.arange(f, device=dev)
    S[fi, :, fi, :] = H_pp
    S = S.reshape(f * 6, f * 6) - Z.T @ Z

    gh = torch.einsum("lba,lb->la", M, g_l).reshape(-1)          # M^T g_l (3L,)
    rhs = -(g_p.reshape(-1) - Z.T @ gh)
    del Z

    # gauge: pose 0 fixed
    mask = torch.cat([torch.zeros(6, **f32), torch.ones((f - 1) * 6, **f32)])
    S = S * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
    rhs = rhs * mask
    S = (S + cfg.damping * torch.diag(torch.abs(torch.diagonal(S)))
         + 1e-6 * torch.eye(f * 6, **f32))
    delta = torch.linalg.solve(S, rhs).reshape(f, 6)
    delta = delta * mask.reshape(f, 6)
    # fixed-shape backtracking line search on the fixed-weight robust cost
    # (same landmarks): a raw step from a far-off linearisation overshoots
    scales = torch.tensor([1.0, 0.5, 0.25, 0.1, 0.03, 0.0], **f32)
    cands = poses @ lie.se3_exp(scales[:, None, None] * delta)   # (6, F, 4, 4)
    uv_, _, _ = _project(cands, X_obs, K)
    rn_ = torch.linalg.norm(uv_ - fxy, dim=-1)
    h_ = torch.clamp(cfg.huber_px / torch.clamp(rn_, min=1e-9), max=1.0)
    costs = torch.sum(w * h_ * rn_ * rn_, (-1, -2))
    return cands[torch.argmin(costs)]


def _pose_step(poses, poses_init, X_obs, fxy, w_obs, K, cfg: ChunkBaConfig):
    """One damped Gauss-Newton step on all poses with the landmarks held:
    the normal equations are block-diagonal over poses. Pose 0 (the
    chunk's overlap frame) is the gauge and stays fixed."""
    r, w, _, J = _residual_blocks(poses, X_obs, fxy, w_obs, K, cfg)
    Jw = J * w[..., None, None]
    H = torch.einsum("fnra,fnrb->fab", Jw, J)
    g = torch.einsum("fnra,fnr->fa", Jw, r)
    eye6 = torch.eye(6, dtype=torch.float32, device=poses.device)
    H = H + cfg.prior_weight * eye6
    g = g + cfg.prior_weight * _prior_twist(poses_init, poses)
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    H = H + cfg.damping * torch.diag_embed(diag) + 1e-8 * eye6
    delta = -cholesky_solve(H, g)
    delta = torch.cat([torch.zeros_like(delta[:1]), delta[1:]])  # gauge
    return poses @ lie.se3_exp(delta)


def refine(poses_init, fxy, fvalid, midx, cinl, K, cfg: ChunkBaConfig, rot_scale=1.0):
    """Refine the chunk's poses against multiview feature tracks.

    poses_init: (F, 4, 4) world-from-camera from the scaled VO chain
    (F = chunk + 1 with the overlap frame). fxy / fvalid: (F, N)
    undistorted keypoints. midx / cinl: (F-1, N) consecutive-pair match
    indices and inlier flags (see build_tracks). Returns (poses,
    mean_reproj_px_before, mean_reproj_px_after, geo_depth, depth_cnt).

    geo_depth / depth_cnt: the multi-view landmark-depth pin statistic:
    the log-median camera-frame depth over landmarks seen in at least 3
    frames, in the gate, in front of the camera and with a ray spread of
    at least about 3 degrees, and the number of such landmarks.
    """
    f, n = fvalid.shape
    num_l = f * n
    ids = build_tracks(midx, cinl, n)
    flat = ids.reshape(-1)
    obs_valid = fvalid.float()

    # only tracks seen in >= 2 frames constrain anything
    cnt0 = _segment_sum(obs_valid.reshape(-1), flat, num_l)
    w_obs = obs_valid * (cnt0 >= 2.0 - 1e-3).float()[ids]

    def mean_err(poses, X):
        uv, z, _ = _project(poses, X[ids], K)
        rn = torch.linalg.norm(uv - fxy, dim=-1)
        okf = ((w_obs > 0) & (z > cfg.min_depth) & (rn < cfg.gate_px)).float()
        return torch.sum(rn * okf) / torch.clamp(torch.sum(okf), min=1.0)

    X0, _ = triangulate_tracks(poses_init, fxy, w_obs, ids, K, num_l)
    err_before = mean_err(poses_init, X0)

    poses = poses_init
    for _ in range(cfg.outer_iters):
        poses = _joint_step(poses, poses_init, ids, fxy, w_obs, K, num_l, cfg, rot_scale)

    # monocular scale-gauge repin: the reprojection cost is flat along the
    # global scale of (trajectory + landmarks), so restore the initial
    # chain's total path length about the gauge pose
    p_init = poses_init[:, :3, 3]
    p_ref = poses[:, :3, 3]
    len_init = torch.sum(torch.linalg.norm(p_init[1:] - p_init[:-1], dim=1))
    len_ref = torch.sum(torch.linalg.norm(p_ref[1:] - p_ref[:-1], dim=1))
    s = len_init / torch.clamp(len_ref, min=1e-9)
    poses = poses.clone()
    poses[:, :3, 3] = p_ref[0] + s * (p_ref - p_ref[0])

    Xf, cntf = triangulate_tracks(poses, fxy, w_obs, ids, K, num_l)
    err_after = mean_err(poses, Xf)

    # pin statistic: geomean depth per landmark, gated on ray conditioning
    # (ray spread s2 = cnt - |sum d|^2 / cnt ~ sum sin^2(angle to the mean ray))
    uvf, zf, _ = _project(poses, Xf[ids], K)
    rnf = torch.linalg.norm(uvf - fxy, dim=-1)
    well = ((w_obs > 0) & (zf > cfg.min_depth) & (rnf < cfg.gate_px)
            & ((cntf >= 3.0 - 1e-3)[ids]))
    wellf = well.float()
    d, _ = _cam_rays_world(poses, fxy, K)
    ocnt = _segment_sum(wellf.reshape(-1), flat, num_l)
    dsum = _segment_sum((d * wellf[..., None]).reshape(-1, 3), flat, num_l)
    s2 = ocnt - torch.sum(dsum * dsum, -1) / torch.clamp(ocnt, min=1.0)
    lzsum = _segment_sum(
        torch.where(well, torch.log(torch.clamp(zf, 1e-3, 1e4)), 0.0).reshape(-1), flat, num_l)
    lz = lzsum / torch.clamp(ocnt, min=1.0)
    lm_ok = (ocnt >= 3.0 - 1e-3) & (s2 >= 3e-3) & torch.isfinite(lz)
    zcnt = torch.sum(lm_ok.float())
    geo_z, _ = masked_log_median(torch.exp(lz), lm_ok)
    return poses, err_before, err_after, geo_z, zcnt
