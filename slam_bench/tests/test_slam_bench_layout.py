"""A configuration, a traffic mix and a per-layer metric, each added as
a new file in a copy of the benchmark (with entries added to its
BENCHMARK.json), are found and run by the harness with no existing file
edited."""

import json
import os
import shutil

from slam_bench.harness import core
from slam_bench.tests import small


def test_new_files_are_found_without_edits(tmp_path):
    root = tmp_path / "checkout"
    root.mkdir()
    shutil.copy(os.path.join(core.ROOT, "BENCHMARK.json"), root)
    shutil.copytree(os.path.join(core.ROOT, "slam_bench"), root / "slam_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in
              (str(q) for q in (root / "slam_bench").rglob("*") if q.is_file())}
    bench = json.load(open(root / "BENCHMARK.json"))
    cfg = json.load(open(root / "slam_bench/configs/euroc_vo_batch11_c16.json"))
    cfg["name"], cfg["sequences"] = "euroc_vo_batch3_c16", 3
    json.dump(cfg, open(root / "slam_bench/configs/euroc_vo_batch3_c16.json", "w"))
    mix = json.load(open(root / "slam_bench/traffic/sweep.json"))
    mix["cycle"] = 100
    json.dump(mix, open(root / "slam_bench/traffic/short_sweep.json", "w"))
    (root / "slam_bench/metrics/rounds_in_window.py").write_text(
        '"""Rounds in the traced window."""\n\n\ndef read(ctx):\n    return ctx["units"]\n')
    name = "vo_batch3.short_sweep"
    limits = json.load(open(root / "slam_bench/limits/vo_batch11.sweep.json"))
    json.dump(limits, open(root / f"slam_bench/limits/{name}.json", "w"))
    bench["configs"].append(dict(bench["configs"][1], name="euroc_vo_batch3_c16",
                                 file="slam_bench/configs/euroc_vo_batch3_c16.json"))
    bench["workloads"].append(dict(bench["workloads"][1], name=name,
                                   config="euroc_vo_batch3_c16", traffic="short_sweep"))
    bench["per_layer"].append({"name": "rounds_in_window", "unit": "rounds", "better": "higher",
                               "source": "host_clock", "layer": "batched front end",
                               "moves": "frames_per_s", "workloads": [name]})
    json.dump(bench, open(root / "BENCHMARK.json", "w"))

    cell = core.find_cell(name, str(root))
    assert cell.config["sequences"] == 3 and cell.traffic["cycle"] == 100
    assert [m["name"] for m in cell.per_layer][-1] == "rounds_in_window"
    over = small.overrides(name, str(root))
    result, _, _ = core.run_cell(name, small.SEED, 4.0, True, device="cpu", root=str(root),
                              overrides=over)
    assert result["metrics"]["rounds_in_window"]["value"] == result["attempted"]
    for p, data in before.items():
        assert open(p, "rb").read() == data, f"{p} was edited"
