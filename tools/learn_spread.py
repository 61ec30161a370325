#!/usr/bin/env python3
"""The spread of the detector's learning gate over training seeds.

tests/test_detector_train.py trains the JAX package's shapes detector
(64 px, width 0.25, 2 classes) for 250 steps at seed 0 and gates the mean
best IoU and the class accuracy on 16 images. This script trains at each
of the given seeds and prints both numbers, for the JAX package on the CPU
and for the port (on the CPU, or on the card with --device cuda), so the
gate's noise can be told from a fault:

    JAX_PLATFORMS=cpu python3 tools/learn_spread.py --seeds 0 1 2 3
    python3 tools/learn_spread.py --package port --device cuda
    JAX_PLATFORMS=cpu python3 tools/learn_spread.py --steps 600 --images 16 64

Each line: package, seed, steps, evaluation images, mean best IoU, class
accuracy over hits, hits. Scored by chip_smoke.best_iou (the first N
images of one seeded stream, so 16 images are the first 16 of 64). About
1 minute a seed at 250 steps on 3 CPU threads.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import best_iou, numpy_detect  # noqa: E402

CFG = dict(input_size=64, width_mult=0.25, depth_mult=0.33, num_classes=2,
           max_detections=20, conf_threshold=0.35)


def run_jax(seed: int, steps: int):
    """The JAX package's model trained `steps` steps at `seed`, as a
    numpy detect function."""
    import jax
    import jax.numpy as jnp

    from aria_slam_tpu.config import DetectorConfig
    from aria_slam_tpu.models import detector_train as dt
    from aria_slam_tpu.models.detect import make_detector

    cfg = DetectorConfig(**CFG)
    det = jax.jit(make_detector(cfg, variables=dt.train(cfg, steps=steps, batch=8, seed=seed)))

    def detect(gray):
        d = det(jnp.asarray(gray))
        return np.asarray(d.boxes), np.asarray(d.classes), np.asarray(d.valid)

    return detect


def run_port(seed: int, steps: int, device: str):
    """The port's model trained `steps` steps at `seed` on `device`, as a
    numpy detect function."""
    from aria_slam_tpu_torch.config import DetectorConfig
    from aria_slam_tpu_torch.models import detect as tdetect, detector_train as tdt

    cfg = DetectorConfig(**CFG)
    model = tdt.train(cfg, steps=steps, batch=8, seed=seed, device=device)
    return numpy_detect(tdetect.make_detector(cfg, model=model, device=device), device)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--steps", type=int, default=250)
    ap.add_argument("--images", type=int, nargs="+", default=[16],
                    help="score on the first N evaluation images, for each N")
    ap.add_argument("--package", choices=("jax", "port", "both"), default="both")
    ap.add_argument("--device", default="cpu", help="the port's device")
    ap.add_argument("--threads", type=int, default=3)
    args = ap.parse_args()
    import torch

    from aria_slam_tpu_torch.models import detector_train as tdt

    torch.set_num_threads(args.threads)
    packages = ("jax", "port") if args.package == "both" else (args.package,)
    for seed in args.seeds:
        for package in packages:
            detect = (run_jax(seed, args.steps) if package == "jax"
                      else run_port(seed, args.steps, args.device))
            for n in args.images:
                miou, acc, hits = best_iou(detect, tdt.make_synthetic_batch, n_images=n)
                print(f"{package} ({'cpu' if package == 'jax' else args.device}) seed {seed}, "
                      f"{args.steps} steps, {n} images: mean IoU {miou:.4f} class accuracy "
                      f"{acc:.4f} on {hits} hits", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
