"""The per-layer metrics that read the program's own record
(utils/profiling.recorded()): a traced run of each cell at the small
size reads a number for every one of them that lists the cell, and each
returns None, without raising, on a program whose profiling module has
no record (the parent of the change that added them)."""

import json
import os

import pytest

from slam_bench.harness import core
from slam_bench.tests import small

BENCH = json.load(open(os.path.join(core.ROOT, "BENCHMARK.json")))
PROGRAM = [m for m in BENCH["per_layer"] if m["source"] in ("program_span", "program_counter")
           and m["name"] not in ("frontend_ms", "backend_ms", "loop_closure_ms")]


@pytest.mark.parametrize("cell", ("full_c32.rotloop_moving", "vo_batch11.sweep"))
def test_a_traced_run_reads_every_program_metric(cell):
    # a short window: whether it reaches the checked sample is not this
    # test's question
    result, _, _ = small.run(cell, seconds=4.0, trace=True)
    for m in PROGRAM:
        if cell not in m["workloads"]:
            continue
        if m["name"] == "loop_accept_pct":
            continue  # a 17-frame sequence never verifies a loop (small.py)
        assert m["name"] in result["metrics"], m["name"]


def test_readers_find_nothing_without_a_record(monkeypatch):
    from aria_slam_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "recorded")
    ctx = dict(spans={"chunk": [0.1, 0.2]}, units=2)
    for m in PROGRAM:
        assert core.load_module("metrics", m["name"]).read(ctx) is None, m["name"]
