#!/usr/bin/env python3
"""The offline EKF's forward pass with two versions of its predict step,
on the CPU, where the evaluator runs the filter (eval/euroc_eval.py,
EKF_DEVICE).

Run from the repository root (no card needed):

    python3 tools/ekf_predict_ab.py [--rounds 3] [--threads 1]

`fusion/ekf.run_sequence` (smooth=False) over a 5,397-event stream, the
size of the eval phase of `chip_smoke.py` (25.7 s of a 200 Hz IMU and 10
fps poses), with `_predict_core` as the package has it (the quaternion
product, the rotation and the skew matrix as constant linear maps, F and
G written by one placement product each) and as the per-entry formulas
of core/lie.py write it (`formula_predict` below, the reference's
_predict_core line for line). Runs alternate formula, maps, maps,
formula, `--rounds` times; prints ms an event for each run and the
largest difference between the two versions' fused positions.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from aria_slam_tpu_torch.config import EkfConfig  # noqa: E402
from aria_slam_tpu_torch.core import lie  # noqa: E402
from aria_slam_tpu_torch.core.types import EkfState  # noqa: E402
from aria_slam_tpu_torch.fusion import ekf  # noqa: E402


def formula_predict(state, t, accel, gyro, cfg, k=None):
    """_predict_core with lie.quat_to_mat, lie.quat_mul and lie.skew, and
    F / G filled block by block."""
    dt = t - state.last_imu_t
    ok = state.initialized & (state.last_imu_t >= 0) & (dt > 0) & (dt <= k.max_dt)
    dt = torch.where(ok, dt, k.zero)
    a = accel - state.ba
    w = gyro - state.bg
    R = lie.quat_to_mat(state.quat)
    quat_new = lie.quat_normalize(lie.quat_mul(state.quat, lie.so3_exp_quat(w * dt)))
    a_world = R @ a + k.g
    pos_new = state.pos + state.vel * dt + 0.5 * a_world * dt * dt
    vel_new = state.vel + a_world * dt
    Ra = R @ lie.skew(a)
    F = k.eye15.clone()
    F[0:3, 3:6] = k.eye3 * dt
    F[0:3, 6:9] = -0.5 * Ra * dt * dt
    F[0:3, 9:12] = -0.5 * R * dt * dt
    F[3:6, 6:9] = -Ra * dt
    F[3:6, 9:12] = -R * dt
    F[6:9, 12:15] = -k.eye3 * dt
    G = torch.zeros((15, 12), dtype=F.dtype, device=F.device)
    G[0:3, 0:3] = 0.5 * R * dt * dt
    G[3:6, 0:3] = R * dt
    G[6:9, 3:6] = k.eye3 * dt
    G[9:12, 6:9] = k.eye3 * dt
    G[12:15, 9:12] = k.eye3 * dt
    P_new = F @ state.P @ F.T + G @ k.Q @ G.T
    P_new = 0.5 * (P_new + P_new.T)
    new = EkfState(pos=torch.where(ok, pos_new, state.pos), vel=torch.where(ok, vel_new, state.vel),
                   quat=torch.where(ok, quat_new, state.quat), ba=state.ba, bg=state.bg,
                   P=torch.where(ok, P_new, state.P),
                   last_imu_t=torch.where(state.initialized, t, state.last_imu_t),
                   initialized=state.initialized)
    return new, F


def stream(seed: int = 0, seconds: float = 25.7):
    rng = np.random.default_rng(seed)
    imu_t = (np.arange(1, round(seconds * 200) + 1) / 200).astype(np.float32)
    accel = (rng.normal(0, 0.1, (len(imu_t), 3)) + [0, 0, 9.81]).astype(np.float32)
    gyro = rng.normal(0, 0.01, (len(imu_t), 3)).astype(np.float32)
    vo_t = (np.arange(round(seconds * 10)) / 10).astype(np.float32)
    vo_R = np.tile(np.eye(3, dtype=np.float32), (len(vo_t), 1, 1))
    vo_p = rng.normal(0, 0.1, (len(vo_t), 3)).astype(np.float32)
    return imu_t, accel, gyro, vo_t, vo_R, vo_p


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--threads", type=int, default=0, help="torch CPU threads (0: as set)")
    args = ap.parse_args()
    if args.threads:
        torch.set_num_threads(args.threads)
    s = stream()
    n = len(s[0]) + len(s[3])
    maps = ekf._predict_core
    out = {}
    print(f"{n} events, torch {torch.__version__}, {torch.get_num_threads()} threads")
    for _ in range(args.rounds):
        for name, fn in (("formula", formula_predict), ("maps", maps), ("maps", maps),
                         ("formula", formula_predict)):
            ekf._predict_core = fn
            try:
                t0 = time.perf_counter()
                pos, _ = ekf.run_sequence(*s, EkfConfig(), smooth=False)
                ms = (time.perf_counter() - t0) * 1e3
            finally:
                ekf._predict_core = maps
            out[name] = pos
            print(f"{name:8s} {ms:9.1f} ms  {ms / n:.4f} ms an event")
    print(f"fused positions of the two versions within "
          f"{float((out['maps'] - out['formula']).abs().max()):.2e} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
