#!/usr/bin/env python3
"""The dynamic-object benchmark's spread at RANSAC seed 0 on the card, and
a witness for the card's RANSAC draws.

chip_smoke.py's phase 14 (a) gates tests/test_dynamic_filter.py's three
tests on one run at seed 0. This script measures how far that run moves
from one run to the next and where the movement comes from, and whether
the card's generator draws as the host's does:

1. spread: phase 14 (a) (chip_smoke.run_dynamic, training included)
   --repeats times in one process: every gated number with its limit
   (unrounded; the gate reads them rounded to 4 places),
   the trained weights' largest difference from the first repeat's and
   each evaluator run's largest trajectory difference from the first's.
2. evaluator: with the first repeat's scenes and weights, each of the
   three evaluator runs --evals times more (trajectories bit-equal or
   not), then twice under torch.use_deterministic_algorithms (with the
   warnings it gives), which makes index_add_ on CUDA deterministic.
3. draws: the object_nofilter run at each of --seeds with the card's
   generator (its draws and masks written to the output directory) and
   with the host generator's draws replayed on the card (chip_smoke
   .ReplaySampler): rotation RPE and |log s| at each seed.
4. histograms: over the masks recorded at the first seed, TorchSampler
   on the card and on the CPU, --draws times each: draws on invalid
   slots, the per-slot frequencies' distance between the two devices
   against the distance between two CPU generators, the rows' mean
   chi-square z against uniform, and the share of minimal samples with a
   repeated index against the uniform law's.

    python3 tools/dynamic_spread.py                    # on the card
    python3 tools/dynamic_spread.py --replay DIR       # on the CPU

--replay runs the object_nofilter evaluation on the CPU with the card's
recorded draws of DIR (the output directory of a card run) replayed in
call order, and prints each seed's reading beside the card's; with
--card-forms the CPU computes the short contractions in the card's forms
(chip_smoke.card_forms), the witness that tells the card's rounding from
a fault of the card. Writes
OUT/spread.json (--out, default dynamic_spread_out). On one H100 the
defaults (3 repeats, 2 more evaluations, 24 seeds) take about 16 min;
the replay on the CPU about 1.5 min a seed on 4 threads.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import math
import os
import sys
import tempfile
import time
import warnings
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402

RUNS = ("clean", "object_nofilter", "object_filtered")
KEYS = ("ate_rmse_m", "ate_noscale_rmse_m", "rpe_rot_deg", "umeyama_scale")


def margins(report) -> list:
    """Every inequality of tests/test_dynamic_filter.py on a report:
    (name, value, limit, passed)."""
    clean, off, on = (report[k] for k in RUNS)
    ls = {k: abs(math.log(report[k]["umeyama_scale"])) for k in RUNS}
    rot = max(8.0 * clean["rpe_rot_deg"], 0.6)
    rows = [("off |log s| > clean + 0.15", ls["object_nofilter"], ls["clean"] + 0.15, ">"),
            ("off ate_noscale > 1.3 clean", off["ate_noscale_rmse_m"],
             1.3 * clean["ate_noscale_rmse_m"], ">"),
            ("off rpe_rot > 2 clean", off["rpe_rot_deg"], 2.0 * clean["rpe_rot_deg"], ">"),
            ("on |log s| < 0.75 off", ls["object_filtered"], 0.75 * ls["object_nofilter"], "<"),
            ("on |log s| < 0.36", ls["object_filtered"], 0.36, "<"),
            ("on ate_noscale <= 1.05 off", on["ate_noscale_rmse_m"],
             1.05 * off["ate_noscale_rmse_m"], "<="),
            ("on ate <= 1.5 off + 0.02", on["ate_rmse_m"], 1.5 * off["ate_rmse_m"] + 0.02, "<="),
            ("off rpe_rot < max(8 clean, 0.6)", off["rpe_rot_deg"], rot, "<"),
            ("on rpe_rot < max(8 clean, 0.6)", on["rpe_rot_deg"], rot, "<")]
    ops = {">": lambda a, b: a > b, "<": lambda a, b: a < b, "<=": lambda a, b: a <= b}
    return [(n, float(v), float(lim), bool(ops[op](v, lim))) for n, v, lim, op in rows]


def load_npz(path) -> dict:
    with np.load(path) as f:
        return {k: f[k] for k in f.files}


def trajectory(out_dir) -> np.ndarray:
    return np.loadtxt(os.path.join(out_dir, "estimated_trajectory.txt"))


def evaluate(scene, out_dir, cfg, device, sampler=None):
    from aria_slam_tpu_torch.eval import euroc_eval

    r = euroc_eval.run(scene, out_dir=out_dir, config=cfg, verbose=False, chunk=cs.DYN_CHUNK,
                       device=device, sampler=sampler)
    return {k: float(r[k]) for k in KEYS}, trajectory(out_dir)


def run_configs(root):
    """The benchmark's three evaluator runs over root's scenes and
    weights: {name: (scene, config)}, as dynamic_benchmark.run builds
    them."""
    import dataclasses

    from aria_slam_tpu_torch.eval import dynamic_benchmark as db

    cfg = db.base_config()
    return {"clean": (f"{root}/scene_clean", cfg),
            "object_nofilter": (f"{root}/scene_object", cfg),
            "object_filtered": (f"{root}/scene_object", dataclasses.replace(
                cfg, enable_detection=True, enable_dynamic_filtering=True,
                detector_weights=f"{root}/object_detector.npz"))}


class Recorder:
    """A sampler that serves `inner`'s draws and keeps them, with the
    masks they were drawn over, on the host."""

    def __init__(self, inner):
        self.inner, self.idx, self.valid = inner, [], []

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        idx = self.inner(valid, num_hypotheses, sample_size, stage)
        self.idx.append(idx.cpu().numpy().astype(np.int16))
        self.valid.append(valid.cpu().numpy())
        return idx


class Replay:
    """Serves recorded draws in call order; counts the calls whose mask
    differs from the recorded one."""

    def __init__(self, idx, valid):
        self.idx, self.valid, self.pos, self.masks_differ = idx, valid, 0, 0

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        want = self.idx[self.pos]
        if want.shape != tuple(valid.shape[:-1]) + (num_hypotheses, sample_size):
            raise RuntimeError(f"call {self.pos}: recorded draws {want.shape} do not fit "
                               f"{tuple(valid.shape)}")
        self.masks_differ += int(not np.array_equal(self.valid[self.pos], valid.cpu().numpy()))
        self.pos += 1
        return torch.from_numpy(want.astype(np.int64)).to(valid.device)


def spread(root, repeats: int) -> dict:
    """Part 1: phase 14 (a) `repeats` times."""
    from aria_slam_tpu_torch.eval import dynamic_benchmark as db, euroc_eval

    reps, first = [], {}
    real_run, real_eval = db.run, euroc_eval.run
    for r in range(repeats):
        tmp = f"{root}/r{r}"
        got, raw = {}, {}

        def keep(*a, **kw):
            got["report"] = real_run(*a, **kw)
            return got["report"]

        def keep_eval(scene, out_dir, **kw):  # the unrounded numbers
            res = real_eval(scene, out_dir=out_dir, **kw)
            raw[os.path.basename(out_dir)] = {k: float(res[k]) for k in KEYS}
            return res

        t0 = time.perf_counter()
        with mock.patch.object(db, "run", keep), mock.patch.object(euroc_eval, "run", keep_eval):
            try:
                _, rec, recs = cs.run_dynamic(tmp)
                error = None
            except AssertionError as e:
                rec, recs, error = None, [], str(e)
        out = f"{tmp}/dynamic"
        weights = load_npz(f"{out}/object_detector.npz")
        trajs = {k: trajectory(f"{out}/{k}") for k in RUNS}
        if r == 0:
            first = dict(weights=weights, trajs=trajs, root=out)
        w_gap = max(float(np.abs(weights[k] - first["weights"][k]).max()) for k in weights)
        t_gap = {k: float(np.abs(trajs[k] - first["trajs"][k]).max()) for k in RUNS}
        m = margins(raw)
        reps.append(dict(seconds=time.perf_counter() - t0, error=error, raw=raw,
                         report={k: got["report"][k] for k in RUNS}, margins=m,
                         weights_max_gap=w_gap, trajectory_max_gap=t_gap,
                         step_ms=rec and rec["step_ms"], launches_by_part=rec and
                         rec["launches_by_part"],
                         kernels=[{k: x[k] for k in ("name", "launches", "ms", "plain_ms",
                                                     "bound_ms", "max_abs_err") if k in x}
                                  for x in recs]))
        cs.log("spread", f"repeat {r}: {'all gates pass' if error is None else error}; "
                         f"weights gap to repeat 0 {w_gap}; trajectory gaps {t_gap}; "
                         + "; ".join(f"{n} {v:.5f} vs {lim:.5f} {'ok' if ok else 'MISS'}"
                                     for n, v, lim, ok in m))
        if recs:
            cs.log("spread", "kernel records: " + "; ".join(
                f"{x['name']} launches {x.get('launches', 'by part')} {x['ms']:.4f} ms"
                for x in recs))
    names = [n for n, *_ in reps[0]["margins"]]
    summary = {n: dict(values=[rp["margins"][i][1] for rp in reps],
                       limits=[rp["margins"][i][2] for rp in reps])
               for i, n in enumerate(names)}
    for s in summary.values():
        s["spread"] = max(s["values"]) - min(s["values"])
    cs.log("spread", "per gate (min, max, spread of the value): " + "; ".join(
        f"{n} {min(s['values']):.5f}-{max(s['values']):.5f} ({s['spread']:.2e})"
        for n, s in summary.items()))
    return dict(repeats=reps, summary=summary, first_root=first["root"])


def evaluator(root, evals: int) -> dict:
    """Part 2: the evaluator alone, on one set of scenes and weights."""
    out = {}
    configs = run_configs(root)
    for name, (scene, cfg) in configs.items():
        base = trajectory(f"{root}/{name}")
        gaps = []
        for e in range(evals):
            _, T = evaluate(scene, f"{root}/eval_{name}", cfg, "cuda")
            gaps.append(float(np.abs(T - base).max()))
        out[name] = dict(gaps_to_repeat0=gaps)
    det = {}
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.use_deterministic_algorithms(True, warn_only=True)
        try:
            for name in ("clean", "object_filtered"):
                scene, cfg = configs[name]
                Ts = [evaluate(scene, f"{root}/det_{name}", cfg, "cuda")[1] for _ in range(2)]
                det[name] = dict(gap_between_two=float(np.abs(Ts[0] - Ts[1]).max()),
                                 gap_to_default=float(np.abs(
                                     Ts[0] - trajectory(f"{root}/{name}")).max()))
        finally:
            torch.use_deterministic_algorithms(False)
    det["warnings"] = sorted({str(w.message).splitlines()[0][:240] for w in caught
                              if "determinis" in str(w.message)})
    out["deterministic_mode"] = det
    cs.log("spread", f"evaluator alone, {evals} more runs each: "
                     + "; ".join(f"{k} {v['gaps_to_repeat0']}" for k, v in out.items()
                                 if k in RUNS)
                     + f"; under use_deterministic_algorithms: {json.dumps(det)}")
    return out


def draws(root, seeds, out_dir) -> list:
    """Part 3: object_nofilter at each seed, the card's generator (draws
    kept) against the host generator's draws replayed on the card."""
    from aria_slam_tpu_torch.ops import epipolar

    scene, cfg = run_configs(root)["object_nofilter"]
    rows = []
    for seed in seeds:
        rec = Recorder(epipolar.TorchSampler(torch.Generator(device="cuda").manual_seed(seed)))
        for kind, sampler in (("card", rec), ("host", cs.ReplaySampler(seed))):
            res, _ = evaluate(scene, f"{root}/draws", cfg, "cuda", sampler)
            rows.append(dict(seed=seed, draws=kind, **res,
                             log_s=abs(math.log(res["umeyama_scale"]))))
        np.savez_compressed(f"{out_dir}/draws_seed{seed}.npz",
                            **{f"idx{i}": x for i, x in enumerate(rec.idx)},
                            **{f"valid{i}": x for i, x in enumerate(rec.valid)})
        cs.log("spread", f"seed {seed}: " + "; ".join(
            f"{r['draws']} rpe_rot {r['rpe_rot_deg']:.4f} |log s| {r['log_s']:.4f}"
            for r in rows[-2:]))
    for kind in ("card", "host"):
        low = [r["seed"] for r in rows if r["draws"] == kind and r["rpe_rot_deg"] < 0.05]
        cs.log("spread", f"{kind} draws: object_nofilter rotation RPE under 0.05 degrees at "
                         f"{len(low)} of {len(seeds)} seeds {low}")
    return rows


def histograms(out_dir, seed: int, n_draws: int) -> dict:
    """Part 4: TorchSampler's draws over the recorded masks of `seed`, on
    the card and on the CPU (two generators)."""
    from aria_slam_tpu_torch.ops import epipolar

    rec = load_npz(f"{out_dir}/draws_seed{seed}.npz")
    calls = [(rec[f"valid{i}"], rec[f"idx{i}"].shape) for i in range(len(rec) // 2)]
    gens = {"card": torch.Generator(device="cuda").manual_seed(1234),
            "cpu": torch.Generator().manual_seed(1234),
            "cpu2": torch.Generator().manual_seed(4321)}
    counts = {k: [] for k in gens}
    dup = {k: [0, 0] for k in gens}
    invalid = {k: 0 for k in gens}
    dup_law = []
    for valid, shape in calls:
        v = valid.reshape(-1, valid.shape[-1])
        nv = v.sum(-1)
        live = np.where(nv > 0, nv, v.shape[-1])
        h, s = shape[-2], shape[-1]
        law = 1 - np.prod([np.clip(1 - k / live, 0, None) for k in range(s)], axis=0)
        dup_law.append((law.sum() * h, len(law) * h))  # weighed as the draws are
        for k, g in gens.items():
            dev = g.device
            sampler = epipolar.TorchSampler(g)
            vt = torch.from_numpy(v).to(dev)
            c = torch.zeros(v.shape, dtype=torch.int64, device=dev)
            for _ in range(n_draws):
                idx = sampler(vt, h, s, "essential")
                c.scatter_add_(1, idx.reshape(v.shape[0], -1), torch.ones_like(
                    idx.reshape(v.shape[0], -1)))
                srt = idx.sort(-1).values
                dup[k][0] += int((srt[..., 1:] == srt[..., :-1]).any(-1).sum())
                dup[k][1] += idx.shape[0] * idx.shape[1]
            c = c.cpu().numpy()
            invalid[k] += int(c[(nv > 0)[:, None] & ~v].sum())
            counts[k].append(c)

    def tv(a, b):  # mean over rows of the total variation distance
        pa = a / a.sum(-1, keepdims=True)
        pb = b / b.sum(-1, keepdims=True)
        return float(np.mean(0.5 * np.abs(pa - pb).sum(-1)))

    def chi_z(c, valid):
        v = valid.reshape(c.shape)
        zs = []
        for row, vr in zip(c, v):
            obs = row[vr] if vr.any() else row
            exp = obs.sum() / len(obs)
            chi = float(((obs - exp) ** 2 / exp).sum())
            dof = len(obs) - 1
            zs.append((chi - dof) / math.sqrt(2 * dof))
        return float(np.mean(zs))

    out = dict(calls=len(calls), draws_per_call=n_draws,
               tv_card_cpu=float(np.mean([tv(a, b) for a, b in zip(counts["card"],
                                                                   counts["cpu"])])),
               tv_cpu_cpu2=float(np.mean([tv(a, b) for a, b in zip(counts["cpu"],
                                                                   counts["cpu2"])])),
               chi_z={k: float(np.mean([chi_z(c, valid) for c, (valid, _)
                                        in zip(counts[k], calls)])) for k in gens},
               invalid_draws=invalid,
               repeated_index_share={k: d[0] / d[1] for k, d in dup.items()},
               repeated_index_law=float(sum(a for a, _ in dup_law) / sum(b for _, b in dup_law)))
    cs.log("spread", f"histograms over the {len(calls)} recorded calls of seed {seed}, "
                     f"{n_draws} draws each: {json.dumps(out)}")
    return out


def card(args) -> int:
    if not torch.cuda.is_available():
        print("dynamic_spread: CUDA is not available (use --replay on the CPU)",
              file=sys.stderr)
        return 1
    from aria_slam_tpu_torch.ops.cuda import _lib

    os.makedirs(args.out, exist_ok=True)
    smi = cs.smi_line()
    cs.log("spread", smi)
    _lib.build_all()
    result = {"device": smi}
    with tempfile.TemporaryDirectory(prefix="dynamic_spread_") as root:
        result["spread"] = spread(root, args.repeats)
        first = result["spread"].pop("first_root")
        result["evaluator"] = evaluator(first, args.evals)
        result["draws"] = draws(first, args.seeds, args.out)
        result["histograms"] = histograms(args.out, args.seeds[0], args.draws)
    with open(f"{args.out}/spread.json", "w") as f:
        json.dump(result, f, indent=1)
    cs.log("spread", f"written {args.out}/spread.json")
    return 0


def replay(args) -> int:
    """The card's recorded draws through the CPU evaluator."""
    from aria_slam_tpu_torch.eval import dynamic_benchmark as db
    from aria_slam_tpu_torch.io import synthetic_scene

    with open(f"{args.replay}/spread.json") as f:
        card_rows = {r["seed"]: r for r in json.load(f)["draws"] if r["draws"] == "card"}
    cfg = db.base_config()
    with tempfile.TemporaryDirectory(prefix="dynamic_replay_") as root:
        # the object scene as dynamic_benchmark.run generates it
        synthetic_scene.generate(f"{root}/scene_object", num_frames=cs.DYN_FRAMES, fps=10.0,
                                 cam=cfg.camera, depth=4.0, traj="sweep", period=10.0,
                                 moving_object=True, object_size=2.2, object_speed=2.8)
        rows = []
        forms = cs.card_forms if args.card_forms else contextlib.nullcontext
        for seed in sorted(set(card_rows) & set(args.seeds)):
            rec = load_npz(f"{args.replay}/draws_seed{seed}.npz")
            n = len(rec) // 2
            sampler = Replay([rec[f"idx{i}"] for i in range(n)],
                             [rec[f"valid{i}"] for i in range(n)])
            with forms():
                res, _ = evaluate(f"{root}/scene_object", f"{root}/out", cfg, "cpu", sampler)
            c = card_rows[seed]
            rows.append(dict(seed=seed, **res, log_s=abs(math.log(res["umeyama_scale"])),
                             calls=sampler.pos, recorded_calls=n,
                             masks_differ=sampler.masks_differ,
                             card_rpe_rot_deg=c["rpe_rot_deg"], card_log_s=c["log_s"]))
            print(f"seed {seed}: CPU{' in the card forms' if args.card_forms else ''} with "
                  f"the card's draws rpe_rot {res['rpe_rot_deg']:.4f} "
                  f"|log s| {rows[-1]['log_s']:.4f}; card rpe_rot {c['rpe_rot_deg']:.4f} "
                  f"|log s| {c['log_s']:.4f}; calls {sampler.pos} of {n}, masks differing "
                  f"from the card's {sampler.masks_differ}", flush=True)
    name = "replay_cpu_card_forms" if args.card_forms else "replay_cpu"
    with open(f"{args.replay}/{name}.json", "w") as f:
        json.dump(rows, f, indent=1)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--evals", type=int, default=2)
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(24)))
    ap.add_argument("--draws", type=int, default=64, help="histogram draws a recorded call")
    ap.add_argument("--out", default=str(ROOT / "dynamic_spread_out"))
    ap.add_argument("--replay", metavar="DIR",
                    help="replay DIR's recorded card draws on the CPU instead")
    ap.add_argument("--card-forms", action="store_true",
                    help="with --replay: the CPU in the card's contraction forms")
    args = ap.parse_args()
    if args.replay:
        torch.set_num_threads(4)
        return replay(args)
    return card(args)


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        sys.exit(main())
