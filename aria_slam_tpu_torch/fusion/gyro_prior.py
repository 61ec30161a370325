"""Per-frame-pair gyroscope rotation priors for the VO chain (the port's
own copy of the JAX package's fusion/gyro_prior.py; numpy only).

A gyro integrated over one frame interval is far more accurate than the
two-view essential-matrix rotation at the same interval. The chunked
front end replaces each pair's VO rotation with the integrated gyro
rotation and re-solves the translation under it; a pair whose visual
RANSAC failed keeps the gyro rotation alone. Integration is a product of
about 20 small rotations a pair and runs on the host.
"""

from __future__ import annotations

import numpy as np


def _so3_exp(w):
    th = float(np.linalg.norm(w))
    if th < 1e-12:
        return np.eye(3)
    k = w / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1.0 - np.cos(th)) * (K @ K)


def pair_rotations(imu_ts, imu_gyro, frame_ts, R_cam_imu=None,
                   gyro_bias=None, min_samples: int = 2):
    """Integrate body rates into per-frame-pair rotation priors.

    imu_ts: (M,) seconds; imu_gyro: (M, 3) rad/s body rates;
    frame_ts: (F,) frame timestamps (seconds, same clock).
    R_cam_imu: (3, 3) camera-from-imu rotation (identity when the body
    frame is the camera frame, as in io/synthetic_scene.py).
    Returns (R_vo (F-1, 3, 3), valid (F-1,)): R_vo in the VO delta
    convention X_cur = R_vo @ X_prev + t, i.e. R_vo = DeltaR^T for the
    integrated body DeltaR.
    """
    imu_ts = np.asarray(imu_ts, np.float64)
    imu_gyro = np.asarray(imu_gyro, np.float64)
    frame_ts = np.asarray(frame_ts, np.float64)
    if gyro_bias is not None:
        imu_gyro = imu_gyro - np.asarray(gyro_bias, np.float64)
    f = len(frame_ts)
    Rs = np.tile(np.eye(3, dtype=np.float32), (max(f - 1, 0), 1, 1))
    valid = np.zeros((max(f - 1, 0),), bool)
    if len(imu_ts) == 0:
        return Rs, valid

    for i in range(f - 1):
        t0, t1 = frame_ts[i], frame_ts[i + 1]
        if t1 <= t0:
            continue
        lo = int(np.searchsorted(imu_ts, t0, side="right"))
        hi = int(np.searchsorted(imu_ts, t1, side="right"))
        if hi - lo < min_samples:
            continue
        dR = np.eye(3)
        t_prev = t0
        for j in range(lo, hi):
            dt = imu_ts[j] - t_prev
            dR = dR @ _so3_exp(imu_gyro[j] * dt)
            t_prev = imu_ts[j]
        if t1 > t_prev:  # close the window with the last sample's rate
            dR = dR @ _so3_exp(imu_gyro[hi - 1] * (t1 - t_prev))
        if R_cam_imu is not None:
            dR = R_cam_imu @ dR @ R_cam_imu.T
        Rs[i] = dR.T.astype(np.float32)  # VO convention R_{cur<-prev}
        valid[i] = True
    return Rs, valid
