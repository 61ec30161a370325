"""One run of one cell: find the cell's files by name, set up, warm up,
measure for the given seconds, trace if asked, check the outputs against
the reference, and print the result line.

Everything that belongs to one configuration, traffic mix or per-layer
metric lives in a file of its own, found by the names in BENCHMARK.json:
  slam_bench/configs/<config>.json     the configuration as it is run
  slam_bench/traffic/<traffic>.json    the mix; its "driver" names
  slam_bench/drivers/<driver>.py       the code that runs that kind of mix
  slam_bench/metrics/<metric>.py       read(ctx) -> number or None
  slam_bench/limits/<workload>.json    the limits of the cell's checks
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
FORBIDDEN = ("jax", "jaxlib", "flax", "aria_slam_tpu")


class Refused(RuntimeError):
    """The run cannot produce a result (no card, a forbidden import)."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    name: str
    workload: dict
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list
    per_layer: list


def find_cell(name: str, root: str = ROOT) -> Cell:
    bench = load_json(os.path.join(root, "BENCHMARK.json"))
    wl = next((w for w in bench["workloads"] if w["name"] == name), None)
    if wl is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == wl["config"])
    config = load_json(os.path.join(root, cfg_entry["file"]))
    traffic = load_json(os.path.join(root, "slam_bench", "traffic", wl["traffic"] + ".json"))
    limits = load_json(os.path.join(root, "slam_bench", "limits", name + ".json"))
    e2e = [m for m in bench["end_to_end"] if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(name, wl, config, traffic, limits, e2e, per_layer)


def load_module(kind: str, name: str, root: str = ROOT):
    """slam_bench/<kind>/<name>.py as a module."""
    path = os.path.join(root, "slam_bench", kind, name + ".py")
    spec = importlib.util.spec_from_file_location(f"slam_bench_{kind}_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Run:
    """What a driver needs and what it leaves for the metrics."""
    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: object
    spans: object = None
    steps: list = field(default_factory=list)   # (t_end, frames) of each unit
    info: dict = field(default_factory=dict)    # shapes and counts for the metrics


def prepare_process(root: str = ROOT):
    """The process's settings, before torch loads: one host thread for
    math libraries (the cells are host-bound, and idle OpenMP workers
    spinning beside the launching thread, or their contention with the
    host's other tenants, make the host's pace and the rates swing from
    run to run), the build and kernel caches at fixed paths inside the
    checkout, and no JAX behind any library."""
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    cache = os.path.join(root, ".bench_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["USE_FLAX"] = "0"
    import torch

    torch.set_num_threads(1)


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def check_limits(numbers: dict, limits: dict):
    """[(name, value, limit, ok)]: a number is within its limit when it is
    at most the limit ("max") or at least it ("min")."""
    out = []
    for name, spec in limits.items():
        v = numbers.get(name)
        ok = v is not None and (v <= spec["max"] if "max" in spec else v >= spec["min"])
        lim = spec["max"] if "max" in spec else spec["min"]
        out.append((name, v, lim, bool(ok)))
    return out


def run_cell(name, seed, seconds, trace, device="cuda", root=ROOT, overrides=None,
             t_start=None, on_check=None):
    """Run one cell once -> (the result dict (the last stdout line), the
    checks [(name, value, limit, ok)], the other numbers of the check). The
    caller has checked the card. overrides: {"config": {...}, "traffic":
    {...}} merged over the cell's files (the CPU tests' small sizes).
    on_check(driver, driver's module): called once the program's outputs
    are checked (the control's readings, slam_bench/control.py)."""
    import torch

    from slam_bench.harness import trace as tr

    t_start = time.perf_counter() if t_start is None else t_start
    cell = find_cell(name, root)
    for key, val in (overrides or {}).items():
        getattr(cell, key).update(val)
    run = Run(cell, int(seed), float(seconds), bool(trace), torch.device(device))
    run.spans = tr.Spans(sync=run.trace and run.device.type == "cuda")
    module = load_module("drivers", cell.traffic["driver"], root)
    driver = module.Driver(run)
    driver.setup()
    on_card = run.device.type == "cuda"
    if on_card:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    prof = tr.Profiler(on_card) if run.trace else None
    run.spans.clear()
    if prof:
        prof.start()
    t0 = time.perf_counter()
    if prof:
        prof.mark(t0)
    while time.perf_counter() - t0 < run.seconds:
        n = driver.step()
        run.steps.append((time.perf_counter(), n))
    if on_card:
        torch.cuda.synchronize()
    device_summary = prof.stop(run.spans) if prof else None
    peak = torch.cuda.max_memory_allocated(run.device) if on_card else 0

    frames = sum(n for _, n in run.steps)
    elapsed = (run.steps[-1][0] - t0) if run.steps else float("nan")
    numbers = driver.check()
    if on_check is not None:
        on_check(driver, module)
    checks = check_limits(numbers, cell.limits)
    correct = all(ok for *_, ok in checks) and bool(run.steps)
    found = forbidden_modules()
    if found:
        raise Refused(f"modules loaded that the run may not load: {found}")

    if run.trace:
        ctx = dict(run=run, spans=run.spans.by_name(), device=device_summary,
                   frames=frames, units=len(run.steps), info=run.info)
        metrics = {}
        for m in cell.per_layer:
            v = load_module("metrics", m["name"], root).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        values = {"frames_per_s": frames / elapsed, "setup_s": setup_s}
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(run.device) if on_card else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if run.trace:
        dev["busy_s"] = device_summary["busy_s"]
        dev["window_s"] = device_summary["window_s"]
    result = {"correct": bool(correct), "attempted": len(run.steps),
              "failed": sum(1 for *_, ok in checks if not ok), "metrics": metrics,
              "device": dev}
    if run.trace:
        result["breakdown"] = device_summary["breakdown"]
    result["checks"] = {n: {"value": v, "limit": lim} for n, v, lim, _ in checks}
    info = {k: v for k, v in numbers.items() if k not in cell.limits}
    return result, checks, info
