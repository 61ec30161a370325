"""The readings that the limits of a cell's checks are set from, on the
card at the cell's own size, in one process:

  the program's readings: a short window of the cell on each seed, its
  outputs checked against the reference as a benchmark run checks them;
  the control's readings: on the control seeds, the reference computed
  in the next precision below the configuration's (TF32 for the float32
  geometry, fp8 operands for the bf16 detector) put in the program's
  place, on the same inputs and draws, checked the same way.

    python slam_bench/control.py --workload <name> --seconds 12 \\
        --seeds 11 12 ... --control-seeds 11 12 13

One JSON line a seed and side on standard output. The benchmark's own
runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def readings(name, seed, seconds, control, device="cuda", root=ROOT, overrides=None):
    """{side: numbers} for one seed from one run of the cell on the
    benchmark's own path: "program", and "control" when asked."""
    from slam_bench.harness import core

    got = {}

    def control_numbers(driver, module):
        got["control"] = module.check_records(driver, driver.records, control="tf32")

    _, checks, info = core.run_cell(name, seed, seconds, False, device=device, root=root,
                                    overrides=overrides,
                                    on_check=control_numbers if control else None)
    return {"program": {**{n: v for n, v, _, _ in checks}, **info}, **got}


def main(argv=None):
    ap = argparse.ArgumentParser(description="readings for a cell's limits")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=12.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=())
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from slam_bench.harness import core

    core.prepare_process()
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 3
    for seed in args.seeds:
        got = readings(args.workload, seed, args.seconds, seed in args.control_seeds)
        for side, nums in got.items():
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side, **nums}),
                  flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
