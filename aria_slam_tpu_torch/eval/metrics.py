"""Trajectory metrics (the port's numpy copy of the JAX package's
eval/metrics.py: Umeyama Sim3 alignment, ATE and rotation RPE)."""

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
