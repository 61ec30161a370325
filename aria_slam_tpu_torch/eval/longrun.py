"""Capacity-scale long-run benchmark (counterpart of the JAX package's
eval/longrun.py).

A >= 1000-frame multi-revisit rotloop (a 200-frame period: about five
passes, so late cycles match keyframes several revisits old) through the
chunked evaluator, overfilling the 512-keyframe ring DB so that eviction
runs. Reports:

  - loop recall and precision against the ground truth: a loop edge (i,
    j) is true when the ground-truth camera centres of frames i and j lie
    within gt_dist_m; an opportunity is a frame with a neighbour at least
    min_frames_between frames older within that radius that is still in
    the DB (a revisit evicted before the camera came back is not
    detectable by any bounded-memory method; evictions are reported);
  - ATE raw / rigid / Sim3, the Umeyama scale, rotation RPE;
  - steady ms a frame and the per-stage steady / first-event split;
  - the DB's fill and evictions;
  - with --diag, each missed opportunity attributed to the loop-closure
    stage that decided it (ChunkedSlam.lc_diag).

Run (on the card; the CPU works with --device cpu, slowly):
  python -m aria_slam_tpu_torch.eval.longrun [--frames 1040] [--full-res]
      [--chunk 16] [--diag] [--out longrun.json]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np


def _gt_positions(data, frames: int) -> np.ndarray:
    from aria_slam_tpu_torch.io import euroc

    pos = np.zeros((frames, 3))
    for i in range(frames):
        t = float(np.clip(data.image_ts[i], data.gt_ts[0], data.gt_ts[-1]))
        pos[i] = euroc.interpolate_gt(data, t)[0]
    return pos


def _opportunity(pos, j: int, min_gap: int, gt_dist_m: float, db_capacity: int) -> bool:
    """Frame j has a ground-truth neighbour in [j - capacity, j - min_gap)
    within gt_dist_m (the ring DB holds the last `capacity` keyframes)."""
    lo, hi = max(0, j - db_capacity), j - min_gap
    return hi > lo and bool(np.any(np.linalg.norm(pos[lo:hi] - pos[j], axis=1) < gt_dist_m))


def loop_truth(data, frames: int, pairs, min_gap: int, gt_dist_m: float, db_capacity: int):
    """Score accepted loop pairs and enumerate the opportunities against
    the ground truth -> (precision, recall, n_true, n_opportunities,
    details). A frame is recalled when an accepted loop edge links it (as
    the query) to a true neighbour."""
    pos = _gt_positions(data, frames)
    # the chunked evaluator pads the last chunk by repeating the last
    # image, so a loop accepted at a pad frame carries an id >= frames:
    # clamp and dedupe
    pairs = sorted({(min(int(i), frames - 1), min(int(j), frames - 1)) for i, j in pairs})
    true_pairs = [(i, j) for i, j in pairs if np.linalg.norm(pos[i] - pos[j]) < gt_dist_m]
    precision = len(true_pairs) / max(len(pairs), 1)
    recalled = {j for _, j in true_pairs}
    opportunities = [j for j in range(frames)
                     if _opportunity(pos, j, min_gap, gt_dist_m, db_capacity)]
    recall = len([j for j in opportunities if j in recalled]) / max(len(opportunities), 1)
    return precision, recall, len(true_pairs), len(opportunities), {
        "accepted": len(pairs), "gt_dist_m": gt_dist_m}


def diag_attribution(data, frames: int, min_gap: int, gt_dist_m: float, db_capacity: int,
                     min_score: float, lc_diag):
    """Attribute each missed opportunity frame to the loop-closure stage
    that decided it (ChunkedSlam.lc_diag):

      recalled  - a true candidate was selected, verified and passed
      verify    - a true candidate was selected but verification rejected
                  every one
      budget    - a true candidate scored >= min_score but lost the
                  chunk's selection budget
      score     - a true candidate reached the prefilter's top k but its
                  exact score fell below min_score
      prefilter - an in-DB true neighbour exists but the histogram
                  prefilter never surfaced it
      no_query  - the chunk produced no eligible candidate at all
    """
    pos = _gt_positions(data, frames)
    by_chunk = {d["base"]: d for d in lc_diag}
    counts = {"recalled": 0, "verify": 0, "budget": 0, "score": 0, "prefilter": 0,
              "no_query": 0}
    best_missed_scores: list = []     # the best true candidate's score, missed frames
    verify_fail_inliers: list = []    # the best inlier count among failed rows
    verify_fail_alternates: list = []  # qualifying true candidates never tried
    for j in range(frames):
        if not _opportunity(pos, j, min_gap, gt_dist_m, db_capacity):
            continue
        d = next((dd for base, dd in by_chunk.items() if base <= j < base + dd["c"]), None)
        if d is None or d["scores"] is None:
            counts["no_query"] += 1
            continue
        i = j - d["base"]
        cand, sc = d["cand_fid"][i], d["scores"][i]
        nk = d["scores"].shape[1]
        valid = cand >= 0
        dist = np.full(nk, np.inf)
        dist[valid] = np.linalg.norm(pos[cand[valid]] - pos[j], axis=1)
        true_m = valid & (dist < gt_dist_m) & (j - cand >= min_gap)
        if not true_m.any():
            counts["prefilter"] += 1
            continue
        if sc[true_m].max() < min_score:
            counts["score"] += 1
            best_missed_scores.append(float(sc[true_m].max()))
            continue
        flat_true = {i * nk + k for k in np.flatnonzero(true_m & (sc >= min_score))}
        sel_rows = [n for n, p in enumerate(d["sel"]) if p in flat_true]
        if not sel_rows:
            counts["budget"] += 1
            continue
        if d["passed"] is not None and any(bool(d["passed"][n]) for n in sel_rows):
            counts["recalled"] += 1
        else:
            counts["verify"] += 1
            if d.get("n_inliers") is not None:
                verify_fail_inliers.append(max(int(d["n_inliers"][n]) for n in sel_rows))
            # true candidates >= min_score that never got a verify slot
            verify_fail_alternates.append(len(flat_true) - len(sel_rows))
    if verify_fail_inliers:
        counts["verify_fail_best_inliers_p50"] = int(np.median(verify_fail_inliers))
        counts["verify_fail_best_inliers_p90"] = int(np.percentile(verify_fail_inliers, 90))
        counts["verify_fail_frames_with_untried_alternates"] = int(
            np.sum(np.asarray(verify_fail_alternates) > 0))
    if best_missed_scores:
        counts["score_miss_best_scores_p50"] = round(float(np.median(best_missed_scores)), 4)
    return counts


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=1040,
                    help=">= 2x the 512-keyframe DB: eviction runs")
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--full-res", action="store_true")
    ap.add_argument("--gt-dist", type=float, default=0.5,
                    help="ground-truth distance under which a loop pair is true")
    ap.add_argument("--scene", default=None)
    ap.add_argument("--out", default="longrun.json")
    ap.add_argument("--diag", action="store_true",
                    help="collect the chunks' loop-closure diagnostics and attribute each "
                         "missed opportunity to a stage (loop_recall_diag)")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    from aria_slam_tpu_torch.eval import euroc_eval
    from aria_slam_tpu_torch.eval.accuracy_benchmark import benchmark_config
    from aria_slam_tpu_torch.io import euroc, synthetic_scene

    cfg = benchmark_config(args.full_res, args.frames)
    out_root = os.path.splitext(args.out)[0] + "_out"
    scene = args.scene or os.path.join(
        out_root, f"scene_{args.frames}{'_full' if args.full_res else ''}")
    if not os.path.exists(os.path.join(scene, "mav0")):
        synthetic_scene.generate(scene, num_frames=args.frames, fps=args.fps, cam=cfg.camera,
                                 depth=4.0, traj="rotloop", period=20.0)
        print(f"scene generated: {scene}", flush=True)

    res = euroc_eval.run(scene, out_dir=out_root, config=cfg, verbose=True, chunk=args.chunk,
                         keep_pipe=True, lc_diag=args.diag, device=args.device)
    pipe = res.pop("_pipe")

    data = euroc.load(scene)
    cap = int(cfg.loop.max_keyframes)
    precision, recall, n_true, n_opp, det = loop_truth(
        data, args.frames, pipe.loop_pairs, int(cfg.loop.min_frames_between), args.gt_dist, cap)
    report = {
        "frames": args.frames,
        "full_res": args.full_res,
        "chunk": args.chunk,
        "kf_capacity": cap,
        "kf_filled": int((pipe.db.frame_id >= 0).sum()),
        "kf_evictions": max(0, args.frames - 1 - cap),  # ring overwrites
        "graph_nodes": args.frames,
        "loops_accepted": det["accepted"],
        "loops_true": n_true,
        "loop_precision": round(precision, 4),
        "loop_recall": round(recall, 4),
        "loop_opportunity_frames": n_opp,
        "gt_dist_m": det["gt_dist_m"],
        "reference_at_500kf": "~50 ms/query, ~70% recall (H09_LOOP_CLOSURE_AUDIT.md:42-48)",
        **{k: (round(v, 4) if isinstance(v, float) else v) for k, v in res.items()},
    }
    if args.diag:
        report["loop_recall_diag"] = diag_attribution(
            data, args.frames, int(cfg.loop.min_frames_between), args.gt_dist, cap,
            float(cfg.loop.min_score), pipe.lc_diag)
    with open(args.out, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({k: v for k, v in report.items() if not k.startswith("stage_")}, indent=1))
    return report


if __name__ == "__main__":
    main()
