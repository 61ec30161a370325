#!/usr/bin/env python3
"""The online pipeline's three tracks on the full-resolution rotloop: the
chain as each frame published it, the final chain (after the loops'
corrections and finalize) and the online EKF's fused track, each with its
Sim3 ATE against the rendered ground truth.

Run from the repository root:

    JAX_PLATFORMS=cpu python3 tools/online_chain_ate.py --package jax
        [--frames 257] [--period 20]
    python3 tools/online_chain_ate.py --package torch [--device cpu]

Writes the rotloop (752x480, 10 fps, the accuracy benchmark's
full-resolution configuration with loop closure, fusion and mapping, as
chip_smoke.py's online phase runs it) with the chosen package's own
generator into a temporary directory and feeds it frame by frame through
that package's SlamPipeline (seed 0; the port on the card unless --device
says otherwise). The JAX run takes about 5 minutes on an 8-core CPU.
Prints the loops and the three ATEs, and whether the fused track passes
tests/test_pipeline.py's gate against each chain (1.1 x + 0.02 m).
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", choices=("torch", "jax"), required=True)
    ap.add_argument("--frames", type=int, default=257)
    ap.add_argument("--period", type=float, default=20.0)
    ap.add_argument("--device", default=None, help="the port's device (default: CUDA)")
    args = ap.parse_args()

    if args.package == "jax":
        sys.path.insert(0, str(ROOT / "tests"))
        import conftest  # noqa: F401  (the tests' JAX settings, before jax is imported)
        from aria_slam_tpu.eval import accuracy_benchmark, metrics
        from aria_slam_tpu.io import euroc, synthetic_scene
        from aria_slam_tpu.pipeline.slam_pipeline import SlamPipeline

        def make(cfg):
            return SlamPipeline(cfg)

        def fused_pos(pipe):
            return np.asarray(pipe.last_output.fused_pos)
    else:
        from aria_slam_tpu_torch.eval import accuracy_benchmark, metrics
        from aria_slam_tpu_torch.io import euroc, synthetic_scene
        from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline

        def make(cfg):
            return SlamPipeline(cfg, device=args.device)

        def fused_pos(pipe):
            return pipe.last_output.fused_pos.cpu().numpy()

    cfg = accuracy_benchmark.benchmark_config(full_res=True, frames=args.frames)
    with tempfile.TemporaryDirectory(prefix="online_chain_ate_") as tmp:
        synthetic_scene.generate(tmp, num_frames=args.frames, fps=10.0, cam=cfg.camera,
                                 depth=4.0, traj="rotloop", period=args.period)
        data = euroc.load(tmp)
        cfg = dataclasses.replace(cfg, camera=data.camera,
                                  imu_cam_rotation=tuple(map(tuple, data.R_cam_imu.tolist())))
        pipe = make(cfg)
        published, fused, t_prev = [], [], -np.inf
        for k in range(args.frames):
            ts = data.image_ts[k]
            imu_t, imu_a, imu_g = euroc.imu_window(data, t_prev, ts)
            for j in range(len(imu_t)):
                pipe.process_imu(imu_t[j], imu_a[j], imu_g[j])
            published.append(pipe.process_frame(euroc.load_image_safe(data.image_paths[k]),
                                                ts)[:3, 3].copy())
            fused.append(fused_pos(pipe))
            t_prev = ts
        pipe.finalize()
        gt = np.stack([synthetic_scene.trajectory(t - data.image_ts[0], kind="rotloop",
                                                  period=args.period)[0]
                       for t in data.image_ts[:args.frames]])
    ate = {"final chain": metrics.ate_rmse(np.stack([T[:3, 3] for _, T in pipe.trajectory]), gt),
           "published chain": metrics.ate_rmse(np.stack(published), gt),
           "fused": metrics.ate_rmse(np.stack(fused), gt)}
    print(f"{args.package}: {args.frames} frames, {pipe.num_loops} loops; Sim3 ATE "
          + ", ".join(f"{k} {v:.4f} m" for k, v in ate.items()))
    for chain in ("final chain", "published chain"):
        ok = ate["fused"] <= 1.1 * ate[chain] + 0.02
        print(f"  fused <= 1.1 x {chain} + 0.02 m: {ok}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
