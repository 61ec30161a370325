"""Trajectory metrics (the port's numpy copy of the JAX package's
eval/metrics.py: Umeyama Sim3 alignment, ATE, RPE, rotation RPE and the
association with ground truth that euroc_eval scores with)."""

from __future__ import annotations

import numpy as np


def align_umeyama(est: np.ndarray, gt: np.ndarray, with_scale: bool = True):
    """Least-squares similarity s, R, t minimising ||gt - (s R est + t)||^2.
    est, gt: (N, 3)."""
    mu_e = est.mean(0)
    mu_g = gt.mean(0)
    xe = est - mu_e
    xg = gt - mu_g
    cov = xg.T @ xe / len(est)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_e = (xe**2).sum() / len(est)
    s = float(np.trace(np.diag(D) @ S) / var_e) if with_scale and var_e > 0 else 1.0
    t = mu_g - s * R @ mu_e
    return s, R, t


def ate_rmse(est: np.ndarray, gt: np.ndarray, align: bool = True,
             with_scale: bool = True) -> float:
    """Absolute trajectory error RMSE (m). est, gt: (N, 3) associated."""
    if len(est) == 0:
        return float("nan")
    if align and len(est) >= 3:
        s, R, t = align_umeyama(est, gt, with_scale)
        est = (s * (R @ est.T)).T + t
    err = np.linalg.norm(est - gt, axis=1)
    return float(np.sqrt((err**2).mean()))


def rpe_rmse(est: np.ndarray, gt: np.ndarray, delta: int = 10) -> float:
    """Relative pose error RMSE over a delta-frame baseline
    (parity: computeRPE, euroc_eval.cpp:43-61)."""
    if len(est) <= delta:
        return float("nan")
    d_est = est[delta:] - est[:-delta]
    d_gt = gt[delta:] - gt[:-delta]
    err = np.linalg.norm(d_est - d_gt, axis=1)
    return float(np.sqrt((err**2).mean()))


def quat_to_mat_np(q: np.ndarray) -> np.ndarray:
    """(..., 4) (w, x, y, z) unit quaternions -> (..., 3, 3) rotations."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3), np.float64)
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


def associate_and_score(data, est_ts, est_T, delta: int = 10):
    """Associate an estimated trajectory with interpolated ground truth and
    score it. data: io/euroc.EurocData; est_ts (N,) timestamps; est_T
    (N, 4, 4) world-from-camera poses.

    Returns (scores, gt_pos, keep): scores = {ate_rmse_m (Sim3),
    ate_raw_rmse_m (no alignment), rpe_rmse_m, rpe_rot_deg, and with 3 or
    more associations umeyama_scale and ate_noscale_rmse_m (rigid)}, NaN
    when nothing associates; gt_pos the (K, 3) associated ground truth;
    keep the matching estimate indices. Ground-truth orientation is
    world-from-body, so estimates go to the body frame first: R_wb =
    R_wc R_cam_imu."""
    from aria_slam_tpu_torch.io import euroc

    est_T = np.asarray(est_T)
    gt_pos, gt_quat, keep = [], [], []
    for i, t in enumerate(est_ts):
        gt = euroc.interpolate_gt(data, float(t))
        if gt is not None:
            gt_pos.append(gt[0])
            gt_quat.append(gt[1])
            keep.append(i)
    gt_pos = np.asarray(gt_pos)
    est_kept = est_T[keep, :3, 3] if keep else est_T[:0, :3, 3]
    if len(gt_pos):
        est_R_body = est_T[keep, :3, :3] @ np.asarray(data.R_cam_imu, est_T.dtype)
        rot = rpe_rot_rmse_deg(est_R_body, quat_to_mat_np(np.asarray(gt_quat)), delta)
    else:
        rot = float("nan")
    scores = {
        "ate_rmse_m": ate_rmse(est_kept, gt_pos) if len(gt_pos) else float("nan"),
        "ate_raw_rmse_m": (ate_rmse(est_kept, gt_pos, align=False) if len(gt_pos)
                           else float("nan")),
        "rpe_rmse_m": rpe_rmse(est_kept, gt_pos, delta) if len(gt_pos) else float("nan"),
        "rpe_rot_deg": rot,
    }
    if len(gt_pos) >= 3:
        s_um, _, _ = align_umeyama(est_kept, gt_pos)
        scores["umeyama_scale"] = float(s_um)
        scores["ate_noscale_rmse_m"] = ate_rmse(est_kept, gt_pos, with_scale=False)
    return scores, gt_pos, keep


def rpe_rot_rmse_deg(est_R: np.ndarray, gt_R: np.ndarray, delta: int = 10) -> float:
    """Rotation relative-pose error RMSE (degrees) over a delta-frame
    baseline."""
    if len(est_R) <= delta:
        return float("nan")
    d_est = np.einsum("nij,nik->njk", est_R[:-delta], est_R[delta:])
    d_gt = np.einsum("nij,nik->njk", gt_R[:-delta], gt_R[delta:])
    err = np.einsum("nij,nkj->nik", d_est, d_gt)
    tr = np.clip((np.trace(err, axis1=1, axis2=2) - 1.0) / 2.0, -1.0, 1.0)
    ang = np.degrees(np.arccos(tr))
    return float(np.sqrt((ang**2).mean()))
