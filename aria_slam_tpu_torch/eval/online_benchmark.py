"""Online (per-frame) throughput, synchronous against pipelined
(counterpart of the JAX package's eval/online_benchmark.py).

The synchronous mode reads every frame's results on the host before
it enqueues the next frame's step; the pipelined mode
(SlamPipeline(lazy_depth=N)) publishes each frame N frames late, so the
host enqueues the next steps while the card runs the earlier ones.
Loop closures apply when their frame is published (later, never
dropped). The reads left inside the step (one a frame with loop
closure on, see pipeline/slam_pipeline.py) still wait for the card.

Prints one JSON line with ms a frame and frames a second of both modes.

Usage:
    python -m aria_slam_tpu_torch.eval.online_benchmark [--frames 48]
        [--depth 3] [--small]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from aria_slam_tpu_torch.config import CameraConfig, OrbConfig, PipelineConfig, RansacConfig


def bench_config(small: bool) -> PipelineConfig:
    """--small: 320x240, 384 features, 3 levels, 128 hypotheses with
    fusion, mapping and loop closure; else the default configuration at
    the EuRoC camera without distortion."""
    if small:
        return PipelineConfig(
            camera=CameraConfig(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                                k1=0.0, k2=0.0, p1=0.0, p2=0.0),
            orb=OrbConfig(num_features=384, num_levels=3),
            ransac=RansacConfig(num_hypotheses=128),
            enable_fusion=True, enable_mapping=True, enable_loop_closure=True)
    return PipelineConfig(camera=CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0))


def make_frames(cfg: PipelineConfig, n: int, seed: int = 0):
    """n rendered uint8 frames along the sweep of a 10 s period at 10 fps
    (a moving camera: every step sees new inputs)."""
    from aria_slam_tpu_torch.io.synthetic_scene import render_frame, scene_layers, trajectory

    layers = scene_layers(4.0, seed)
    return [render_frame(cfg.camera, None, *trajectory(k / 10.0, period=10.0), depth=4.0,
                         layers=layers).astype(np.uint8) for k in range(n)]


def run_mode(cfg, frames, lazy_depth: int, warmup: int = 4, device=None,
             keep_pipe: bool = False):
    """Steady ms a frame of the online pipeline over `frames` after
    `warmup` frames, the host clock read after every dispatched frame
    was published and the card finished; keep_pipe: -> (ms, pipe)."""
    from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline

    pipe = SlamPipeline(cfg, lazy_depth=lazy_depth, device=device)

    def sync():
        if pipe.device.type == "cuda":
            torch.cuda.synchronize(pipe.device)

    for k in range(warmup):
        pipe.process_frame(frames[k % len(frames)], 0.1 * k)
    pipe.flush()
    sync()
    t0 = time.perf_counter()
    for k in range(warmup, len(frames)):
        pipe.process_frame(frames[k], 0.1 * k)
    pipe.flush()
    sync()
    ms = (time.perf_counter() - t0) / max(len(frames) - warmup, 1) * 1000.0
    return (ms, pipe) if keep_pipe else ms


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=48)
    ap.add_argument("--depth", type=int, default=3, help="pipelined mode lazy depth")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    cfg = bench_config(args.small)
    frames = make_frames(cfg, args.frames)
    sync_ms = run_mode(cfg, frames, lazy_depth=0, device=args.device)
    pipe_ms = run_mode(cfg, frames, lazy_depth=args.depth, device=args.device)
    out = {
        "online_sync_ms_per_frame": round(sync_ms, 2),
        "online_pipelined_ms_per_frame": round(pipe_ms, 2),
        "online_sync_fps": round(1000.0 / sync_ms, 2),
        "online_pipelined_fps": round(1000.0 / pipe_ms, 2),
        "speedup": round(sync_ms / pipe_ms, 3),
        "lazy_depth": args.depth,
        "frames": args.frames,
    }
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
