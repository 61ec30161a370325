#!/usr/bin/env python3
"""chip_smoke.py's navigation phase (15) alone, in a fresh process.

Run from the repository root on a machine with one NVIDIA H100:

    python3 tools/navigation_phase.py [--out navigation.json]

Builds the three kernels, writes the first chip_smoke.NAV_FRAMES frames
of the rotloop at 752x480 with generate() (filter-0 PNGs), renders
NAV_STAGED_FRAMES sweep frames, and runs chip_smoke.run_navigation with
its gates: (a) the navigation example with --detect on the PNGs, then
(b) the staged pipeline against synchronous steps at PipelineConfig()'s
width. In chip_smoke.py the phase runs after nine others, whose host
timings drift; here the process is fresh, so the two runs side by side
show the drift. Exits non-zero without a card or when a gate fails.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="write the phase's record to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("navigation_phase: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 1
    import chip_smoke as cs
    from aria_slam_tpu_torch.config import CameraConfig
    from aria_slam_tpu_torch.io import synthetic_scene
    from aria_slam_tpu_torch.ops.cuda import _lib

    cs.log("device", f"{torch.cuda.get_device_name(0)} | {cs.smi_line()}")
    _lib.build_all()
    cam = CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    with tempfile.TemporaryDirectory(prefix="navigation_phase_") as tmp:
        t0 = time.perf_counter()
        synthetic_scene.generate(f"{tmp}/rotloop", num_frames=cs.NAV_FRAMES, fps=cs.FPS,
                                 cam=cam, depth=4.0, traj="rotloop", period=cs.LOOP_PERIOD)
        frames, gt, imu = cs.render_frames(cam, cs.NAV_STAGED_FRAMES, cs.FPS)
        cs.log("render", f"{cs.NAV_FRAMES} rotloop PNGs and {cs.NAV_STAGED_FRAMES} sweep "
                         f"frames in {time.perf_counter() - t0:.1f} s")
        launches_a, launches_b, rec, _ = cs.run_navigation(tmp, frames, gt, imu, cam)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(rec, launches_a=launches_a, launches_b=launches_b,
                           nvidia_smi=cs.smi_line()), f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
