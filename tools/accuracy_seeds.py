#!/usr/bin/env python3
"""Seed spread of the accuracy regression scene, for both packages, on
the CPU.

Run from the repository root (no card needed; it imports the JAX
package as the parity tests do):

    JAX_PLATFORMS=cpu python3 tools/accuracy_seeds.py [--seeds 0 1 2 3]
        [--package both|torch|jax]

Writes the rotloop of tests/test_torch_accuracy.py (140 frames at
320x240, 12 s period, 10 fps) with the port's generator into a temporary
directory and runs each package's euroc_eval.run at chunk 16 with the
configuration of tests/test_accuracy.py, loop closure on, once a seed:
the port on a torch generator seeded with it (epipolar.TorchSampler, the
card's draws), the JAX package with ChunkedSlam(seed=...) (its key
chain). Prints one line a run: Sim3 ATE, loops, Umeyama scale.
"""

from __future__ import annotations

import argparse
import functools
import os
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3])
    ap.add_argument("--package", choices=("both", "torch", "jax"), default="both")
    args = ap.parse_args()

    import conftest  # noqa: F401  (the tests' JAX settings, before jax is imported)
    import torch

    from aria_slam_tpu_torch import config as tcfg
    from aria_slam_tpu_torch.eval import euroc_eval as teval
    from aria_slam_tpu_torch.io import synthetic_scene
    from aria_slam_tpu_torch.ops import epipolar
    from test_torch_accuracy import CAM_KW, CHUNK, _cfg

    with tempfile.TemporaryDirectory(prefix="accuracy_seeds_") as tmp:
        scene = os.path.join(tmp, "scene")
        synthetic_scene.generate(scene, num_frames=140, fps=10.0,
                                 cam=tcfg.CameraConfig(**CAM_KW), depth=4.0, traj="rotloop",
                                 period=12.0)
        runs = []
        if args.package in ("both", "torch"):
            for seed in args.seeds:
                sampler = epipolar.TorchSampler(torch.Generator().manual_seed(seed))
                runs.append(("torch", seed, lambda s=sampler: teval.run(
                    scene, out_dir=os.path.join(tmp, "out"), config=_cfg(tcfg), verbose=False,
                    chunk=CHUNK, device="cpu", sampler=s)))
        if args.package in ("both", "jax"):
            from aria_slam_tpu import config as jcfg
            from aria_slam_tpu.eval import chunked as jchunked
            from aria_slam_tpu.eval import euroc_eval as jeval

            def jax_run(seed):
                plain = jchunked.ChunkedSlam
                jchunked.ChunkedSlam = functools.partial(plain, seed=seed)
                try:
                    return jeval.run(scene, out_dir=os.path.join(tmp, "out"),
                                     config=_cfg(jcfg), verbose=False, chunk=CHUNK)
                finally:
                    jchunked.ChunkedSlam = plain

            for seed in args.seeds:
                runs.append(("jax", seed, functools.partial(jax_run, seed)))
        for package, seed, fn in runs:
            r = fn()
            print(f"{package:5s} seed {seed}: Sim3 ATE {r['ate_rmse_m']:.4f} m, loops "
                  f"{r['loops']}, umeyama_scale {r['umeyama_scale']:.4f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
