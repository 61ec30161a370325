"""Synthetic IMU streams with analytic ground truth (the port's own copy
of the JAX package's fusion/synthetic.py, plain numpy).

Parity: reference SyntheticIMU (include/legacy/SyntheticIMU.hpp):
deterministic circular / linear motion at 200 Hz with Gaussian noise,
used to validate the EKF without a dataset (the reference's only
self-contained correctness check, SURVEY.md §4.1).

Body frame convention (matches the reference's test): the body yaws at
rate omega while circling, so body-frame accel is the constant
centripetal vector; gravity is + 9.81 on z (the accelerometer measures
specific force).
"""

from __future__ import annotations

import numpy as np


def circular_motion(duration_s=10.0, imu_hz=200.0, radius=2.0, omega=0.5,
                    accel_noise=0.01, gyro_noise=0.001, seed=42,
                    body_frame=True):
    """Returns dict of numpy arrays: imu_t, accel, gyro (measured, noisy),
    and analytic gt_pos(t)/gt_rot(t) callables.

    body_frame=True produces a physically consistent accelerometer
    (specific force in body axes: f_b = R^T (a_world - g)); with
    body_frame=False it reproduces the reference's simplification of
    feeding world-axis accel (SyntheticIMU.hpp:13-40), useful only for
    behavioral parity checks.
    """
    rng = np.random.default_rng(seed)
    n = int(duration_s * imu_hz)
    t = np.arange(n) / imu_hz

    ax = -radius * omega**2 * np.cos(omega * t)
    ay = -radius * omega**2 * np.sin(omega * t)
    az = np.full_like(t, 9.81)  # a_world_z - g_z = 0 - (-9.81)
    f_world = np.stack([ax, ay, az], -1)
    if body_frame:
        c, s = np.cos(omega * t), np.sin(omega * t)
        # R(t)^T applied to the xy components (yaw about z)
        fx = c * f_world[:, 0] + s * f_world[:, 1]
        fy = -s * f_world[:, 0] + c * f_world[:, 1]
        f_world = np.stack([fx, fy, f_world[:, 2]], -1)
    accel = f_world + rng.normal(0, accel_noise, (n, 3))

    gyro = np.stack(
        [np.zeros_like(t), np.zeros_like(t), np.full_like(t, omega)], -1
    ) + rng.normal(0, gyro_noise, (n, 3))

    def gt_pos(tt):
        tt = np.asarray(tt)
        return np.stack(
            [radius * np.cos(omega * tt), radius * np.sin(omega * tt), np.zeros_like(tt)],
            -1,
        )

    def gt_rot(tt):
        a = omega * np.asarray(tt)
        c, s = np.cos(a), np.sin(a)
        zero, one = np.zeros_like(a), np.ones_like(a)
        return np.stack(
            [
                np.stack([c, -s, zero], -1),
                np.stack([s, c, zero], -1),
                np.stack([zero, zero, one], -1),
            ],
            -2,
        )

    def gt_vel(tt):
        tt = np.asarray(tt)
        return np.stack(
            [
                -radius * omega * np.sin(omega * tt),
                radius * omega * np.cos(omega * tt),
                np.zeros_like(tt),
            ],
            -1,
        )

    return {
        "imu_t": t.astype(np.float32),
        "accel": accel.astype(np.float32),
        "gyro": gyro.astype(np.float32),
        "gt_pos": gt_pos,
        "gt_rot": gt_rot,
        "gt_vel": gt_vel,
    }
