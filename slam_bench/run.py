"""Run one cell of the benchmark once on this machine's card.

    python slam_bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted, failed, metrics (the cell's end-to-end metrics, or with
--trace 1 its per-layer metrics), device, with --trace 1 the breakdown,
and last the checks (each compared number with its limit), which also
end standard error. Exits 3 without a result when there is no CUDA card
or fewer than the cell asks for, and with an error, without a result,
when a module of JAX or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None):
    ap = argparse.ArgumentParser(description="one run of one benchmark cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from slam_bench.harness import core

    core.prepare_process()
    import torch

    chips = core.find_cell(args.workload).workload["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"this cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 3
    result, checks, info = core.run_cell(args.workload, args.seed, args.seconds, args.trace,
                                         t_start=T_START)
    for name, value in info.items():
        print(f"info {name}: {value}", file=sys.stderr)
    for name, value, limit, ok in checks:
        print(f"check {name}: {value} (limit {limit}) {'ok' if ok else 'FAILED'}",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
