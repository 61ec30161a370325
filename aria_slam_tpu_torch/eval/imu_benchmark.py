"""IMU fusion benchmark (counterpart of the JAX package's
eval/imu_benchmark.py; parity: the reference's
experiments/benchmark_imu.cpp): a circular-motion 200 Hz IMU and 20 Hz
visual updates through the 15-state EKF (fusion/ekf.run_sequence), the
fused position against the analytic ground truth at every visual update.

Usage: python -m aria_slam_tpu_torch.eval.imu_benchmark [--duration 10]
    [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np


def run(duration_s: float = 10.0, imu_hz: float = 200.0, vo_hz: float = 20.0,
        verbose: bool = True, device=None) -> dict:
    """-> {"mean_err_m", "max_err_m"} over the visual updates after the
    fifth. The filter runs on `device` (CUDA unless asked otherwise)."""
    import torch

    from aria_slam_tpu_torch.config import EkfConfig
    from aria_slam_tpu_torch.fusion import ekf, synthetic
    from aria_slam_tpu_torch.pipeline.slam_pipeline import resolve_device

    dev = resolve_device(device)
    data = synthetic.circular_motion(duration_s, imu_hz)
    vo_t = (np.arange(int(duration_s * vo_hz)) / vo_hz + 0.001).astype(np.float32)
    vo_R = data["gt_rot"](vo_t).astype(np.float32)
    vo_p = data["gt_pos"](vo_t).astype(np.float32)

    # host timestamps keep run_sequence's sortedness check live
    pos, _ = ekf.run_sequence(
        np.asarray(data["imu_t"], np.float32), torch.as_tensor(data["accel"], device=dev),
        torch.as_tensor(data["gyro"], device=dev), np.asarray(vo_t),
        torch.as_tensor(vo_R, device=dev), torch.as_tensor(vo_p, device=dev), EkfConfig(),
        device=dev)
    pos = pos.cpu().numpy()
    gt = data["gt_pos"](vo_t)
    err = np.linalg.norm(pos - gt, axis=1)

    if verbose:
        print(f"=== IMU fusion benchmark ({duration_s:.0f}s, "
              f"{imu_hz:.0f}Hz IMU + {vo_hz:.0f}Hz visual, {dev}) ===")
        for i in range(0, len(vo_t), max(1, len(vo_t) // 20)):
            print(f"t={vo_t[i]:5.2f}s  fused=({pos[i,0]:+.3f},{pos[i,1]:+.3f},"
                  f"{pos[i,2]:+.3f})  gt=({gt[i,0]:+.3f},{gt[i,1]:+.3f},"
                  f"{gt[i,2]:+.3f})  err={err[i]*100:.1f}cm")
        print(f"mean error: {err[5:].mean()*100:.2f} cm   "
              f"max error: {err[5:].max()*100:.2f} cm")
    return {"mean_err_m": float(err[5:].mean()), "max_err_m": float(err[5:].max())}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--duration", type=float, default=10.0)
    ap.add_argument("--imu-hz", type=float, default=200.0)
    ap.add_argument("--vo-hz", type=float, default=20.0)
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    return run(args.duration, args.imu_hz, args.vo_hz, device=args.device)


if __name__ == "__main__":
    main()
