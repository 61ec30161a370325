#!/usr/bin/env python3
"""Which RANSAC draws flip a pair between the card's contraction forms and
the CPU's, on the same features and draws.

chip_smoke.check_geometry holds the card's geometry (ops/linalg.dot /
matvec and ops/epipolar._apply as a product and a sum) against the CPU
route (einsum / matmul) at one draw seed. This script runs the same check
over several (lag, seed) cells and adds the witness: the CPU route with
the card's forms forced (chip_smoke.card_forms). A pair "flips" when its
success flag differs or its rotation differs by more than 5e-3 (another
hypothesis won). If the witness flips against the CPU on the cells where
the card does, and stays close to the card, the card's flips are the
forms' rounding and not a fault of the card:

    python3 tools/geometry_flips.py                 # on the card
    python3 tools/geometry_flips.py --device cpu    # CPU features, no card

Each line: lag, seed, then for card/CPU, witness/CPU and witness/card the
largest rotation gap, the largest translation angle, the inlier-mask
agreement and the flipped pairs. About 2 s a cell on the card.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--lags", type=int, nargs="+", default=[4, 8, 16])
    ap.add_argument("--seeds", type=int, nargs="+", default=[0, 1, 2, 3, 4, 5])
    ap.add_argument("--pairs", type=int, default=cs.GEOM_PAIRS)
    ap.add_argument("--device", default="cuda", help="where the features and the card "
                    "route run; with cpu only the witness against the CPU is printed")
    args = ap.parse_args()
    from aria_slam_tpu_torch.config import CameraConfig

    dev = torch.device(args.device)
    cam = CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0)  # chip_smoke's camera
    t0 = time.perf_counter()
    frames, _, _ = cs.render_frames(cam, args.pairs + max(args.lags), cs.FPS)
    print(f"rendered {len(frames)} frames in {time.perf_counter() - t0:.1f} s", flush=True)
    cpu = torch.device("cpu")
    totals = {}

    def show(name, g):
        totals[name] = totals.get(name, 0) + g["flipped"]
        return (f"{name} R {g['R_err']:.2e} t {g['t_deg']:.3f} deg masks "
                f"{g['mask_agree'] * 100:.3f} % ok-equal {g['ok_equal']} flipped {g['flipped']}")

    for lag in args.lags:
        inputs = cs.geometry_inputs(frames, cam, dev, lag, args.pairs)
        for seed in args.seeds:
            sampler = cs.ReplaySampler(seed)
            host, _ = cs.geometry_run(inputs, cam, sampler, cpu)
            with cs.card_forms():
                forms, _ = cs.geometry_run(inputs, cam, sampler, cpu)
            parts = [show("witness/cpu", cs.geometry_gaps(forms, host))]
            if dev.type == "cuda":
                card, _ = cs.geometry_run(inputs, cam, sampler, dev)
                parts = [show("card/cpu", cs.geometry_gaps(card, host))] + parts + [
                    show("witness/card", cs.geometry_gaps(forms, card))]
            print(f"lag {lag} seed {seed}: " + "; ".join(parts), flush=True)
    cells = len(args.lags) * len(args.seeds)
    print(f"flipped pairs over {cells} cells of {args.pairs} pairs: "
          + ", ".join(f"{k} {v}" for k, v in totals.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
