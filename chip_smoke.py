#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (aria_slam_tpu_torch).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py [--out details.json]

Phases, one line each; any failure raises and exits non-zero:

1. device  -- requires CUDA; prints the card's name and power limit.
2. build   -- compiles the three CUDA kernels from csrc/ (nvcc, sm_90a)
              and prints nvcc's -Xptxas -v report.
3. kernels -- each kernel against its plain PyTorch version on the card,
              at the shapes of the online VO slice (752x480, 8 levels,
              2000 features) and of the chunked path (B = 33 frames,
              N = 32 and 29 pairs) and of the online loop closure (N = 8
              candidates, N = 5 verify pairs): the corner maps bit-equal at
              B = 1, 3 and 33, the match results bit-exact on thirteen cases
              up to N = 256 pairs of 2000x2000, the patches of all 8 levels
              exactly equal at B = 1, 3 and 33 (detector keypoints, and
              edge centres),
              and rBRIEF from one product over all levels against one a
              level (bits identical where the angle bin is; changed bins
              printed). Device times (CUDA graph replay, launch cost
              excluded) of the kernel, the plain version and, where one
              exists, PyTorch calls computing the same function (timed
              here, never used by the port), beside the least time the
              card could take and the kernel's time with its launch cost;
              the corner and patch kernels also at B = 33 frames (the
              chunked front end's one launch a chunk), the match kernel
              also at N = 4, 5, 8, 32 (a chunk's consecutive pairs) and 256.
4. slice   -- 20 rendered frames through the port's own entry points
              (factory.create_gpu, SlamPipeline.process_imu /
              process_frame / finalize) in the VO-only configuration at
              full EuRoC width; checks the kernels' launch counts (one
              launch each of the corner, patch and match kernels a
              frame), the VO success share and the Sim3 ATE against the
              rendered ground truth.
5. chunked -- 97 rendered frames (3 chunks of 32 with an overlap of 1) with
              their IMU stream and gyro priors through
              eval.chunked.ChunkedSlam.process_chunk x 3 and finalize():
              the front end batched over the 32 + 29 pairs of a chunk,
              chunk BA, the IMU metric scale and the pose-graph chain.
              Prints the StageTimer's ms a chunk and stage (first chunk
              apart), ms a frame, peak memory, the share of pairs that
              succeeded, the IMU correction and the Sim3 ATE; checks the
              launch counts (a chunk: corner 1, patch 1, match 2), at
              least 90 % of pairs, finite poses and ATE < 0.35 m. With
              --profile also the kernels and cudaLaunchKernel calls of
              one steady chunk and the device's busy share.
6. loop    -- the accuracy benchmark's full-resolution configuration
              (the port's eval/accuracy_benchmark.benchmark_config(full_res=
              True), the JAX package's as it is: loop gates 150 / 0.3 /
              40, 512 keyframes, vo_backbone_scale, mapping into a
              100,000-point map) with loop closure on: 257
              rendered frames of the rotloop trajectory (20 s period, 10
              fps, so frames 200-256 revisit frames 0-56) in 8 chunks of
              32 with the IMU stream and gyro priors, then the same run
              with loop closure off. Prints ms a chunk and a frame, the
              StageTimer stages (loop_query / loop_verify / loop_optimize
              among them, state_update with the map insert), finalize ms,
              the map's point count, peak memory, the loops found, their
              precision against the rendered ground truth (true when the
              two frames lie within 0.5 m) and both Sim3 ATEs; checks the
              launch counts (corner 8, patch 8, match 3 x 8 plus one a
              chunk that verified; the match kernel's launches inside
              lc_query and verify_batch are read from its counter around
              each call, one and one), at least one loop at precision >=
              0.9, finite poses and ATE with loops <= 1.15 x ATE without +
              0.02 m. Then the match kernel on the last verify batch's own
              inputs against its plain version (bit-exact) and timed there.
              With --profile also one steady chunk that verifies.
7. eval    -- the evaluator's own entry point: the port's
              io/synthetic_scene.generate writes the same 257-frame
              rotloop as an ASL directory (PNGs, IMU, ground truth) and
              eval/euroc_eval.run reads it at chunk 32 in the accuracy
              benchmark's three variants, vo / vio / vio_lc, each with the
              kernels' counts set to 0 just before it. Prints every ATE
              flavour (Sim3, rigid, raw, the fused ones), the Umeyama
              scale, loops and their precision, map points, steady frame
              ms, fps, every stage with its count (decode on the worker
              thread, the EKF's forward pass and smoother among them),
              the generate time, peak memory, and the EKF once more on the
              device the evaluator does not use for it. vo reads the
              generator's PNGs (row filter 0: the decoder's flat path);
              then every frame is rewritten with each row's filter chosen
              as libpng chooses it (Average and Paeth rows, as real EuRoC
              files have: the decoder's anti-diagonal walk), and vio and
              vio_lc read those. One chunk's decode is also timed alone in
              both encodings (in this process and split over the
              evaluator's decode processes), and each variant prints its
              decode ms a chunk beside its device_chunk ms and the main
              thread's wait for frames (decode_wait). Fails unless every
              pose is finite, the launch counts are a run's (corner 8,
              patch 8, match 16, or 24 plus one a verifying chunk with loop
              closure), vio_lc finds a loop at precision >= 0.9 and its ATE
              is <= 1.15 x vio's + 0.02 m, each fused track's Sim3 and raw
              ATE are within 1e-3 m of its chain's or below, and map.ply
              holds map_points points.
8. online  -- the port's default online entry point, euroc_eval.run with
              chunk=0, on the eval phase's rotloop directory (libpng-
              filtered PNGs) in the vio_lc configuration (fusion, loop
              closure, mapping), counts set to 0 just before it: Sim3 /
              rigid / raw ATE and the fused three, loops and their
              precision, frame step ms (median, p90, with and without a
              verify), loop_optimize ms a loop, finalize ms, the online
              EKF's frame steps replayed on the host and on the card (ms a
              frame each), launches a frame (match by role: N = 8 scores a
              frame, N = 5 on verifying frames), peak memory. Fails unless
              poses are finite, a loop is found at precision >= 0.9, the
              fused Sim3 ATE <= 1.1 x that of the chain as published frame
              by frame (what the EKF consumed) + 0.02 m, map.ply holds
              map_points points and the launch counts are the run's. Then
              PipelineConfig() as it is (a 512-keyframe DB, a 200,000-point
              map, a 4096-node graph) on 40 frames, and
              online_benchmark.run_mode in sync and in lazy mode (depth 3)
              on 24 full-width frames: both ms a frame, the trajectories
              within 1e-5 m.
9. detect  -- the object detector, YOLO-s at 640 px in bf16
              (DetectorConfig() with random weights from a seeded
              torch.Generator). (a) alone on 752x480 frames, make_detector
              at B = 1 with NMS and make_batched_detector at B = 33
              without: the whole call, preprocess, forward (also its
              device time in a CUDA graph), decode, postprocess and NMS
              timed apart, kernels a call, peak memory, the convolutions'
              input dtype (fails unless bf16) and the bound from the
              layer shapes (operations at the bf16 peak against the
              function's bytes); the same weights and frame through the
              port on the CPU (logits within DET_LOGIT_TOL of each level's
              largest, the same anchors past the gate outside that band)
              and the card's postprocess and NMS against the CPU's on the
              card's decoded output (equal). (b) the slice's 20 frames
              through factory.create_gpu with detection and dynamic
              filtering on (the slice's VO-only configuration, gate
              DET_CONF): step median and p90 beside the VO-only slice's,
              the detector's span on the stream, num_filtered a frame,
              launches (corner, patch, match 1 a frame), and the last
              step's detections equal to make_detector's. (c) generate
              (moving_object=True) writes MOVING_FRAMES frames and
              boxes.csv; euroc_eval.run(chunk=0) on the first
              MOVING_ONLINE_FRAMES with a detector that returns the
              ground-truth panel box as a person (the factory's detector=
              argument), then without detection: num_filtered, VO
              success, Umeyama scale, Sim3 and scale-fixed ATE (fails
              unless every frame with the box in view, at least
              MIN_BOX_PX a side, filters a match and VO succeeds on 90 %).
              (d) euroc_eval.run(chunk=32) in vio on that directory with
              YOLO-s in the front end (B = 33, no NMS) and without:
              device_chunk ms, launches (corner 8, patch 8, match 16),
              peak memory.
10. multi  -- generate() writes four full-width sweeps of 65 frames (each
              its own period and seed), the pin probe's rotloop and the
              photometric stress scene, in parallel processes.
              eval.multi_eval.run_scenes at chunk 16 on a one-card NCCL
              mesh (parallel/mesh.single_process_group) with S = 4 in one
              batched program a round (B = 68 frames an extract, N = 64
              pairs a match launch), counts set to 0 just before it; then
              the same four sequences one at a time (S = 1), back to back.
              Prints ms a steady round (after the first) and its stages,
              steady sequence-frames a second at S = 4 against S = 1,
              each run's first round and start-up apart, the whole runs'
              times, launches a round, peak memory and
              every Sim3 ATE (fails unless launches are 1 / 1 / 1 a round,
              each sequence's poses at S = 4 equal its poses alone, and
              every ATE is finite and < 0.35 m). Then the three
              kernels at B = 68 and N = 64 against their plain versions.
11. db     -- parallel/sharded_db.sharded_topk_scores on the same mesh: one
              query against a 512-keyframe DB at F = 2000 with two planted
              revisits (one match launch at N = 512), against
              ops/match.match_scores_vs_database and the plain route on
              the card (same top-5, equal scores slot for slot, the
              planted revisits found); its time, peak memory (the query's
              repeat for every keyframe beside the DB), and the match
              kernel at N = 512 against its plain version (best, second
              and best index equal element by element).
12. aux    -- eval.imu_benchmark.run(10 s) on the card (mean error < 5 cm),
              eval.pin_probe.run(full_res=True, frames=60) (each
              estimator's median ratio; finite), and the stressed scene
              (noise 6, exposure drift 0.3, blur 3 px, 33 frames) through
              euroc_eval.run at chunk 16 (Sim3 ATE < 0.5 m).

The line before the last holds the card's name and power limit as
nvidia-smi reports them, the one before it the kernels' JSON record (each
kernel at the online slice's shape with that slice's launches, at the
chunked path's shape with that path's, the match kernel at the loop
path's two shapes, the verify batch on that run's own inputs, with the
launches counted inside lc_query and verify_batch, at the online loop
closure's two, with the launches of the online phase, and each kernel at
the online and chunked shapes once more with the launches of the detect
phase's runs (b) and (d), and the kernels at the multi and db phases'
shapes with those phases' launches), and the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import tempfile
import time
from unittest import mock

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_MS = 3.35e12 / 1e3
F32_OPS_PER_MS = 67e12 / 1e3
INT8_OPS_PER_MS = 1979e12 / 1e3

# float32 operations per output pixel of the corner rank map as the plain
# version does them: FAST-9 (16 ring differences, 16 negations, 16 arcs x
# 16 minima, 2 x 15 arc maxima, 3 for the score), 3x3 NMS (9 maxima, 2
# compares), Sobel (2 x 7), the three gradient products, separable 7x7 box
# sums of three maps (3 x 12), Harris (7) and the final select (1). More
# than the function needs (see corner_ops); kept to compare with the
# bound of earlier records only.
PLAIN_CORNER_OPS_PER_PX = 16 + 16 + 256 + 30 + 3 + 11 + 14 + 3 + 36 + 7 + 1

NUM_FRAMES = 20          # the online slice
CHUNK = 32
NUM_CHUNKS = 3
CHUNKED_FRAMES = NUM_CHUNKS * CHUNK + 1
FPS = 10.0
LOOP_CHUNKS = 8          # the loop phase: 257 frames of the rotloop
LOOP_FRAMES = LOOP_CHUNKS * CHUNK + 1
LOOP_PERIOD = 20.0
LOOP_TRUE_M = 0.5        # a loop pair is true when its frames lie this close


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 30, warmup: int = 3, repeats: int = 5) -> float:
    """Time of fn() in ms: the median over `repeats` of the mean from CUDA
    events around `iters` back-to-back calls, after `warmup` calls. Where a
    call's device work is shorter than its host cost (allocation, checks,
    the launch), this measures the host, whose clock a shared machine
    disturbs; the median keeps one disturbed repeat out."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(repeats):
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / iters)
    return float(np.median(times))


def graph_ms(fn, iters: int = 20, replays: int = 10) -> float:
    """Mean device time of fn() in ms: `iters` calls captured in one CUDA
    graph and replayed `replays` times between CUDA events, so the host's
    launch cost is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up off the capture, as torch asks
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (iters * replays)


def bound(nbytes: float, ops: float, ops_per_ms: float):
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_MS, ops / ops_per_ms
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def match_bound(q, t, v):
    """The match kernel's bound: its inputs read and three int32 outputs
    written once, and a 256-bit Hamming distance (an int8 product) for
    every query-train pair."""
    n, kq, kt = q.shape[0], q.shape[1], t.shape[1]
    return bound(q.numel() + t.numel() + v.numel() + 3 * 4 * n * kq,
                 2.0 * n * kq * kt * 256, INT8_OPS_PER_MS)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip()


def ptxas_lines(report: str) -> list:
    """nvcc's -Xptxas -v lines that name a kernel (mangled) and give its
    registers, shared memory and spills."""
    return [ln.strip() for ln in report.splitlines()
            if "Function properties" in ln or "registers" in ln or "spill" in ln]


def corner_ops(levels, ranks, threshold: float, box_r: int) -> int:
    """Float32 operations that the rank maps `ranks` of `levels` need on
    this data, done the cheapest way known, each step exact: at every pixel
    the compass test (4 ring differences, 8 compares), which gives most
    pixels a score of exactly 0; at the pixels that pass it the rest of
    FAST-9 (12 differences, per polarity 64 doubling-window and 15 arc
    min/max ops, one negation, 3 for the score); at the NMS survivors the
    NMS (9 maxima, 2 compares) and Harris, the cheaper of a dense pass
    (Sobel 14, products 3, separable box sums 3 x 4r, Harris 7 a pixel) and
    one window a survivor (Sobel and products at (2r+1)^2 pixels, three box
    sums, Harris). A positive score that NMS drops is not counted."""
    from aria_slam_tpu_torch.ops.cuda.corner_kernel import _edge_pad

    win = (2 * box_r + 1) ** 2
    ops = 0
    for lvl, rank in zip(levels, ranks):
        h, w = lvl.shape[-2:]
        p = _edge_pad(lvl, 3)
        c = p[:, 3: 3 + h, 3: 3 + w]
        n = [p[:, 3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] - c
             for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
        cand = ((sum((x > threshold).int() for x in n) >= 2)
                | (sum((x < -threshold).int() for x in n) >= 2))
        n_cand, n_corner = int(cand.sum()), int((rank > -1e38).sum())
        ops += 12 * lvl.numel() + (12 + 2 * (64 + 15) + 4) * n_cand + 11 * n_corner
        ops += min((14 + 3 + 12 * box_r + 7) * lvl.numel(),
                   (17 * win + 3 * (win - 1) + 7) * n_corner)
    return ops


def render_frames(cam, n: int, fps: float, kind: str = "sweep", period: float = 20.0):
    """n frames of the multi-depth synthetic scene along the trajectory
    `kind` of the given period, their ground-truth positions, and the
    200 Hz IMU stream."""
    from aria_slam_tpu_torch.io import synthetic_scene as ss

    layers = ss.scene_layers(4.0, 0)
    frames, gt = [], []
    for k in range(n):
        pos, R = ss.trajectory(k / fps, kind=kind, period=period)
        frames.append(ss.render_frame(cam, None, pos, R, layers=layers))
        gt.append(pos)
    return frames, np.stack(gt), ss.imu_samples(n / fps, traj=kind, period=period)


# --------------------------------------------------------------- kernels
MATCH_COMMON = dict(route="cuda", source="aria_slam_tpu_torch/csrc/match_kernel.cu",
                    replaces="aria_slam_tpu/ops/pallas/match_kernel.py:56", library_ms=None,
                    wrapper="match_top2_batched")


def check_match(dev, rng):
    from aria_slam_tpu_torch.ops.cuda import _lib
    from aria_slam_tpu_torch.ops.cuda import match_kernel as mk

    def case(n, kq, kt, invalid=0.1, dup=False, all_invalid=False):
        q = rng.integers(0, 2, (n, kq, 256)).astype(np.int8)
        t = rng.integers(0, 2, (n, kt, 256)).astype(np.int8)
        if dup:  # exact copies and ties: second == best, lowest index wins
            t[:, : min(kq, kt) // 2] = q[:, : min(kq, kt) // 2]
            t[:, min(kq, kt) // 2: min(kq, kt)] = q[:, : min(kq, kt) - min(kq, kt) // 2]
        v = rng.random((n, kt)) >= invalid
        if all_invalid:
            v[:] = False
        return (torch.from_numpy(q).to(dev), torch.from_numpy(t).to(dev),
                torch.from_numpy(v).to(dev))

    def case_on_card(n, kq, kt, invalid=0.1, seed=1):
        g = torch.Generator(device=dev).manual_seed(seed)
        return (torch.randint(0, 2, (n, kq, 256), generator=g, device=dev, dtype=torch.int8),
                torch.randint(0, 2, (n, kt, 256), generator=g, device=dev, dtype=torch.int8),
                torch.rand((n, kt), generator=g, device=dev) >= invalid)

    cases = {"N1": case(1, 2000, 2000), "N4": case(4, 2000, 2000),
             "ragged": case(2, 300, 777), "dups": case(1, 500, 600, dup=True),
             "all_invalid": case(1, 70, 130, all_invalid=True), "kt1": case(3, 65, 1, 0.0),
             "kq5": case(3, 5, 640), "kt1001": case(2, 700, 1001),
             "N32": case_on_card(32, 2000, 2000, seed=2),
             "N29": case_on_card(29, 2000, 2000, seed=3),
             "N8": case_on_card(8, 2000, 2000, seed=4),
             "N5": case_on_card(5, 2000, 2000, seed=5),
             "N256": case_on_card(256, 2000, 2000)}
    for name, args in cases.items():
        got = mk.match_top2_batched(*args)
        want = mk.match_top2_plain(*args)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("best", "second", "best_idx")):
            if not torch.equal(g, w):
                raise AssertionError(f"match {name}: {what} differs from the plain version "
                                     f"at {int((g != w).sum())} queries")
        del got, want
        torch.cuda.empty_cache()  # the plain N = 256 run holds ~20 GB of temporaries
    sms = _lib.sm_count(dev.index)
    rows, plans = {}, {}
    for name in ("N1", "N4", "N5", "N8", "N32", "N256"):
        q, t, v = cases[name]
        n, kq, kt = q.shape[0], q.shape[1], t.shape[1]
        slices, _ = mk.split_plan(n, kq, kt, sms)
        plans[name] = dict(slices=slices, blocks=n * -(-kq // mk._QUERY_BLOCK) * slices)
        big = n > 16
        ms = graph_ms(lambda: mk.match_top2_batched(q, t, v),
                      iters=5 if big else 20, replays=4 if big else 10)
        b_ms, by = match_bound(q, t, v)
        rows[name] = dict(ms=ms, bound_ms=b_ms, bound_by=by)
    q, t, v = cases["N1"]
    launch_ms = cuda_ms(lambda: mk.match_top2_batched(q, t, v), iters=50)
    plain_ms = graph_ms(lambda: mk.match_top2_plain(q, t, v))
    q32, t32, v32 = cases["N32"]
    rows["N32"]["launch_ms"] = cuda_ms(lambda: mk.match_top2_batched(q32, t32, v32), iters=10)
    rows["N32"]["plain_ms"] = graph_ms(lambda: mk.match_top2_plain(q32, t32, v32),
                                       iters=2, replays=3)
    # the online loop closure: N = 8 candidate scores, N = 5 verify pairs;
    # N = 4 has no path (the plain time completes its row)
    for name in ("N4", "N5", "N8"):
        q_, t_, v_ = cases[name]
        rows[name]["launch_ms"] = cuda_ms(lambda: mk.match_top2_batched(q_, t_, v_), iters=20)
        rows[name]["plain_ms"] = graph_ms(lambda: mk.match_top2_plain(q_, t_, v_), iters=4,
                                          replays=5)
    # N = 256: the loop path's candidate scores (32 frames x 8 candidates)
    q256, t256, v256 = cases["N256"]
    rows["N256"]["launch_ms"] = cuda_ms(lambda: mk.match_top2_batched(q256, t256, v256), iters=5)
    rows["N256"]["plain_ms"] = cuda_ms(lambda: mk.match_top2_plain(q256, t256, v256), iters=1,
                                       warmup=0, repeats=1)
    torch.cuda.empty_cache()
    log("kernels", f"match: bit-exact on {len(cases)} cases; plain N=1 {plain_ms:.4f} ms, "
                   f"N=4 {rows['N4']['plain_ms']:.4f} ms, N=5 {rows['N5']['plain_ms']:.4f} ms, "
                   f"N=8 {rows['N8']['plain_ms']:.4f} ms, "
                   f"N=32 {rows['N32']['plain_ms']:.4f} ms, N=256 {rows['N256']['plain_ms']:.4f} "
                   "ms (once); "
                   + "; ".join(f"{k} 2000x2000 kernel {r['ms']:.4f} ms (bound {r['bound_ms']:.5f} "
                               f"ms, {r['bound_by']}; {plans[k]['slices']} slices, "
                               f"{plans[k]['blocks']} blocks)" for k, r in rows.items())
                   + f"; with launch cost N1 {launch_ms:.4f} ms, N32 "
                     f"{rows['N32']['launch_ms']:.4f} ms")
    rows["N1"].update(plain_ms=plain_ms, launch_ms=launch_ms)
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "launch_ms")
    return [dict(name="match_top2 N=1", path="online", **MATCH_COMMON, max_abs_err=0.0,
                 **{k: rows["N1"][k] for k in keys}),
            dict(name="match_top2 N=32", path="chunked", **MATCH_COMMON, max_abs_err=0.0,
                 **{k: rows["N32"][k] for k in keys}),
            dict(name="match_top2 N=256 (loop candidate scores)", path="loop", role="query",
                 **MATCH_COMMON, max_abs_err=0.0, **{k: rows["N256"][k] for k in keys}),
            dict(name="match_top2 N=8 (online loop candidate scores)", path="online_lc",
                 role="query", **MATCH_COMMON, max_abs_err=0.0,
                 **{k: rows["N8"][k] for k in keys}),
            dict(name="match_top2 N=5 (online loop verify)", path="online_lc", role="verify",
                 **MATCH_COMMON, max_abs_err=0.0, **{k: rows["N5"][k] for k in keys})], \
        {"match": rows, "match_plans": plans}


def check_verify_match(q, t, v):
    """The match kernel on the loop run's own verify batch (the inputs of
    its last launch in loop_verify) against the plain version: max
    absolute error over (best, second, best_idx), which must be 0, and
    the device times."""
    from aria_slam_tpu_torch.ops.cuda import match_kernel as mk

    got = mk.match_top2_batched(q, t, v)
    want = mk.match_top2_plain(q, t, v)
    err = max(int((g.long() - w.long()).abs().max()) for g, w in zip(got, want))
    del got, want
    torch.cuda.empty_cache()
    if err:
        raise AssertionError(f"match on the loop verify batch: max abs error {err}")
    b_ms, by = match_bound(q, t, v)
    rec = dict(name=f"match_top2 N={q.shape[0]} (loop verify)", path="loop", role="verify",
               **MATCH_COMMON, max_abs_err=float(err),
               ms=graph_ms(lambda: mk.match_top2_batched(q, t, v), iters=5, replays=4),
               launch_ms=cuda_ms(lambda: mk.match_top2_batched(q, t, v), iters=10),
               plain_ms=graph_ms(lambda: mk.match_top2_plain(q, t, v), iters=2, replays=3),
               bound_ms=b_ms, bound_by=by)
    torch.cuda.empty_cache()
    log("kernels", f"match on the loop run's verify batch ({tuple(q.shape)} x {tuple(t.shape)}, "
                   f"{float(v.float().mean()):.3f} valid): bit-exact; kernel {rec['ms']:.4f} ms "
                   f"(bound {b_ms:.5f} ms, {by}), with launch cost {rec['launch_ms']:.4f} ms, "
                   f"plain {rec['plain_ms']:.4f} ms")
    return rec


def pyramid_levels(frames, cfg, dev):
    """The ORB pyramid of `frames`: a list of (B, H_l, W_l) level images."""
    from aria_slam_tpu_torch.ops.pyramid import build_pyramid

    imgs = torch.from_numpy(np.stack(frames).astype(np.float32)).to(dev)
    return [lvl.contiguous() for lvl in build_pyramid(imgs, cfg.num_levels, cfg.scale_factor)]


def level_inputs(frames, cfg, dev):
    """Per pyramid level: the (B, H, W) level images, their 5x5-blurred
    copies and the level's keypoints from the ORB detector, B frames."""
    from aria_slam_tpu_torch.ops import brief, orb
    from aria_slam_tpu_torch.ops.cuda.corner_kernel import corner_rank_maps

    levels = pyramid_levels(frames, cfg, dev)
    ranks = corner_rank_maps(levels, cfg.fast_threshold, cfg.harris_block_size)
    quotas = orb.features_per_level(cfg.num_features, cfg.num_levels, cfg.scale_factor)
    out = []
    for lvl, rank, q in zip(levels, ranks, quotas):
        xy, _, _ = orb._select_keypoints(rank, q, cfg.edge_threshold)
        out.append((lvl, brief.smooth_for_brief(lvl).contiguous(), xy.contiguous()))
    return out


def check_corner(frames, cfg, dev):
    from aria_slam_tpu_torch.ops.cuda import corner_kernel as ck

    thr, hb = cfg.fast_threshold, cfg.harris_block_size
    corners = []
    for b in (33, 3, 1):
        levels = pyramid_levels(frames[:b], cfg, dev)
        for lvl, got in zip(levels, ck.corner_rank_maps(levels, thr, hb)):
            want = ck.corner_rank_map_plain(lvl, thr, hb)
            if not torch.equal(got, want):
                mg, mw = got > -1e38, want > -1e38
                both = (got - want)[mg & mw].abs()
                raise AssertionError(f"corner B={b} {tuple(lvl.shape)}: not bit-equal; masks "
                                     f"differ at {int((mg != mw).sum())} pixels, max abs diff "
                                     f"{float(both.max()) if both.numel() else 0.0}")
            if b == 1:
                corners.append(int((want > -1e38).sum()))
    rows = {}
    for b in (1, 33):
        levels = pyramid_levels(frames[:b], cfg, dev)
        px = sum(lvl.numel() for lvl in levels)
        ms = graph_ms(lambda: ck.corner_rank_maps(levels, thr, hb))
        ops = corner_ops(levels, ck.corner_rank_maps(levels, thr, hb), thr, hb // 2)
        b_ms, by = bound(2 * 4 * px, ops, F32_OPS_PER_MS)
        plain_b_ms, _ = bound(2 * 4 * px, PLAIN_CORNER_OPS_PER_PX * px, F32_OPS_PER_MS)
        rows[f"B{b}"] = dict(ms=ms, bound_ms=b_ms, bound_by=by, ops_per_px=ops / px,
                             plain_ops_bound_ms=plain_b_ms, megapixels=px / 1e6)
    for b in (1, 33):
        levels = pyramid_levels(frames[:b], cfg, dev)
        big = b > 1
        rows[f"B{b}"]["launch_ms"] = cuda_ms(lambda: ck.corner_rank_maps(levels, thr, hb),
                                             iters=10 if big else 50)
        rows[f"B{b}"]["plain_ms"] = graph_ms(
            lambda: [ck.corner_rank_map_plain(lvl, thr, hb) for lvl in levels],
            iters=2 if big else 5, replays=2 if big else 4)
    launch_ms, plain_ms = rows["B1"]["launch_ms"], rows["B1"]["plain_ms"]
    log("kernels", f"corner: bit-equal (torch.equal) on {len(levels)} levels x B=1,3,33; "
                   f"corners per level {corners}; plain B=1 {plain_ms:.4f} ms, B=33 "
                   f"{rows['B33']['plain_ms']:.4f} ms; "
                   + "; ".join(f"{k} one launch {r['ms']:.4f} ms (bound {r['bound_ms']:.5f} ms, "
                               f"{r['bound_by']}, {r['ops_per_px']:.1f} ops/px needed, "
                               f"{r['megapixels']:.3f} Mpx; {r['plain_ops_bound_ms']:.5f} ms "
                               f"at the plain version's {PLAIN_CORNER_OPS_PER_PX} ops/px)"
                               for k, r in rows.items())
                   + f"; B1 with launch cost {launch_ms:.4f} ms")
    common = dict(route="cuda", source="aria_slam_tpu_torch/csrc/corner_kernel.cu",
                  replaces="aria_slam_tpu/ops/pallas/corner_kernel.py:125", max_abs_err=0.0,
                  library_ms=None, wrapper="corner_rank_maps")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "launch_ms")
    return [dict(name="corner_rank_map B=1", path="online", **common,
                 **{k: rows["B1"][k] for k in keys}),
            dict(name="corner_rank_map B=33", path="chunked", **common,
                 **{k: rows["B33"][k] for k in keys})], {"corner": rows}


def centres_anywhere(rng, b: int, shape, n: int, dev):
    """(b, n, 2) float32 centres anywhere on an image of `shape` and up to
    3 px past it, to exercise the corner clamp and the edge repetition."""
    h, w = shape
    return torch.from_numpy(np.stack([rng.uniform(-3, w + 3, (b, n)),
                                      rng.uniform(-3, h + 3, (b, n))], -1)
                            .astype(np.float32)).to(dev)


def patch_bytes(blurred, xys, indices) -> int:
    """Least traffic of the patch kernel: the image pixels the patches
    cover, each read once, the centres, and the patches written."""
    nbytes = 0
    for img, xy, (yy, xx) in zip(blurred, xys, indices):
        b, h, w = img.shape
        covered = torch.zeros((b, h, w), dtype=torch.bool, device=img.device)
        bi = torch.arange(b, device=img.device)[:, None, None, None]
        covered[bi, yy.expand(-1, -1, -1, xx.shape[-1]), xx.expand(-1, -1, yy.shape[-2], -1)] = True
        nbytes += 4 * int(covered.sum()) + 4 * xy.numel() + 4 * yy.numel() * xx.shape[-1]
    return nbytes


def check_descriptors(blurred, xys, cfg):
    """rBRIEF of one BRIEF product over all levels' patches (the main path)
    against one product a level: the bits must agree wherever the angle bin
    does. Returns (changed angle bins, keypoints, max abs angle diff)."""
    from aria_slam_tpu_torch.ops import brief
    from aria_slam_tpu_torch.ops.cuda import patch_kernel as pk

    pattern = brief.brief_pattern(cfg.descriptor_bits, cfg.patch_size, cfg.brief_seed)
    once_d, once_a = brief.describe_and_orient(
        pk.extract_patches_levels(blurred, xys, brief.PATCH_R).flatten(2), pattern)
    per = [brief.describe_and_orient(pk.extract_patches(img, xy, brief.PATCH_R).flatten(2),
                                     pattern) for img, xy in zip(blurred, xys)]
    per_d, per_a = torch.cat([d for d, _ in per], 1), torch.cat([a for _, a in per], 1)
    same_bin = brief.angle_bin(once_a) == brief.angle_bin(per_a)
    if not torch.equal(once_d[same_bin], per_d[same_bin]):
        raise AssertionError("BRIEF bits differ between one product and one a level at "
                             f"{int((once_d != per_d).any(-1)[same_bin].sum())} keypoints "
                             "of the same angle bin")
    return (int((~same_bin).sum()), same_bin.numel(),
            float((once_a - per_a).abs().max()))


def check_patch(frames, cfg, dev, rng):
    from aria_slam_tpu_torch.ops import brief
    from aria_slam_tpu_torch.ops.cuda import patch_kernel as pk

    radius = brief.PATCH_R
    # all 8 levels in one call, exact: the detector's keypoints, and the
    # same plus 64 centres a level anywhere, edges and corners included
    for b in (1, 3, 33):
        inputs = level_inputs(frames[:b], cfg, dev)
        blurred = [img for _, img, _ in inputs]
        det = [xy for _, _, xy in inputs]
        edge = [torch.cat([xy, centres_anywhere(rng, b, img.shape[-2:], 64, dev)], 1)
                for img, xy in zip(blurred, det)]
        for what, xys in (("detector", det), ("detector + edge", edge)):
            got = pk.extract_patches_levels(blurred, xys, radius)
            want = pk.extract_patches_levels_plain(blurred, xys, radius)
            if not torch.equal(got, want):
                raise AssertionError(f"patch B={b} {what}: differs from the plain version at "
                                     f"{int((got != want).sum())} of {got.numel()} floats")
        if b > 3:  # the chunk's shape: the BRIEF comparison would hold two 2 GB products
            log("kernels", f"patch B={b}: one launch for {len(blurred)} levels exactly equal "
                           "(detector keypoints, + 64 edge centres a level)")
            continue
        changed, keys, max_da = check_descriptors(blurred, det, cfg)
        log("kernels", f"patch B={b}: one launch for {len(blurred)} levels exactly equal "
                       f"(detector keypoints, "
                       f"+ 64 edge centres a level); BRIEF once over all levels against once "
                       f"a level: {changed} of {keys} angle bins changed, bits identical "
                       f"where the bin is, max angle diff {max_da:.3g} rad")
    rows = {}
    for b in (1, 33):
        inputs = level_inputs(frames[:b], cfg, dev)
        blurred = [img for _, img, _ in inputs]
        xys = [xy for _, _, xy in inputs]
        indices = [pk.patch_indices(img.shape, xy, radius) for img, xy in zip(blurred, xys)]
        bi = torch.arange(b, device=dev)[:, None, None, None]
        big = b > 1
        reps = dict(iters=5, replays=4) if big else {}
        ms = graph_ms(lambda: pk.extract_patches_levels(blurred, xys, radius), **reps)
        launch_ms = cuda_ms(lambda: pk.extract_patches_levels(blurred, xys, radius),
                            iters=10 if big else 50)
        plain_ms = graph_ms(lambda: pk.extract_patches_levels_plain(blurred, xys, radius), **reps)
        # one advanced-indexing gather a level, summed
        lib_ms = graph_ms(lambda: [img[bi, yy, xx] for img, (yy, xx) in zip(blurred, indices)],
                          **reps)
        b_ms, by = bound(patch_bytes(blurred, xys, indices), 0.0, F32_OPS_PER_MS)
        blocks = b * pk.level_plan([xy.shape[1] for xy in xys])[1][-1]
        rows[f"B{b}"] = dict(ms=ms, launch_ms=launch_ms, plain_ms=plain_ms, library_ms=lib_ms,
                             bound_ms=b_ms, bound_by=by, blocks=blocks)
    log("kernels", "patch: " + "; ".join(
        f"{k} one launch ({row['blocks']} blocks) {row['ms']:.4f} ms, "
        f"{100 * row['bound_ms'] / row['ms']:.1f} % of its bound {row['bound_ms']:.5f} ms "
        f"({row['bound_by']}), with launch cost {row['launch_ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, one indexing call a level {row['library_ms']:.4f} ms"
        for k, row in rows.items()))
    common = dict(route="cuda", source="aria_slam_tpu_torch/csrc/patch_kernel.cu",
                  replaces="aria_slam_tpu/ops/pallas/patch_kernel.py:60", max_abs_err=0.0,
                  wrapper="extract_patches_levels")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "launch_ms")
    return [dict(name="extract_patches B=1", path="online", **common,
                 **{k: rows["B1"][k] for k in keys}),
            dict(name="extract_patches B=33", path="chunked", **common,
                 **{k: rows["B33"][k] for k in keys})], {"patch": rows}


# ----------------------------------------------------------------- slice
def run_slice(frames, gt, imu, cam):
    from aria_slam_tpu_torch.config import PipelineConfig
    from aria_slam_tpu_torch.eval import metrics
    from aria_slam_tpu_torch.ops.cuda import corner_kernel, match_kernel, patch_kernel
    from aria_slam_tpu_torch.pipeline import factory

    kernels = (corner_kernel.corner_rank_maps, patch_kernel.extract_patches_levels,
               match_kernel.match_top2_batched)

    cfg = PipelineConfig(camera=cam, enable_fusion=False, enable_loop_closure=False,
                         enable_mapping=False)
    pipe = factory.create_gpu(cfg)
    gc.collect()  # drop the kernel phase's graphs and tensors before measuring memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    for k in kernels:
        k.launches = 0
    step_ms, outs = drive_frames(pipe, frames, imu, lambda o: (
        int(o.num_features), int(o.num_matches), int(o.num_inliers), bool(o.vo_success)))
    launches = {k.__name__: k.launches for k in kernels}
    t0 = time.perf_counter()
    pipe.finalize()
    torch.cuda.synchronize()
    fin_ms = (time.perf_counter() - t0) * 1e3
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    est = np.stack([T[:3, 3] for _, T in pipe.trajectory])
    ate = metrics.ate_rmse(est, gt)
    feats, matches, inliers, ok = (np.array(c) for c in zip(*outs))
    steady = np.array(step_ms[1:])
    success = float(ok[1:].mean())
    log("slice", f"{len(frames)} frames {cam.width}x{cam.height}, VO-only: step ms median "
                 f"{np.median(steady):.2f} p90 {np.percentile(steady, 90):.2f} (first frame "
                 f"{step_ms[0]:.1f}), finalize {fin_ms:.1f} ms; mean features {feats.mean():.1f}, "
                 f"matches {matches[1:].mean():.1f}, inliers {inliers[1:].mean():.1f}; "
                 f"vo_success {success:.3f}; Sim3 ATE {ate:.4f} m; peak memory {peak_mb:.1f} MiB "
                 f"({base_mb:.1f} MiB held before the slice); "
                 f"launches {launches}")
    n = len(frames)
    want = {"corner_rank_maps": n, "extract_patches_levels": n, "match_top2_batched": n}
    if launches != want:
        raise AssertionError(f"launch counts {launches}, expected {want}")
    if not success >= 0.9:
        raise AssertionError(f"vo_success share {success:.3f} < 0.9")
    if not (np.isfinite(est).all() and ate < 0.35):
        raise AssertionError(f"Sim3 ATE {ate} m (limit 0.35 m)")
    return launches, dict(step_ms=step_ms, finalize_ms=fin_ms, ate_m=ate,
                          vo_success=success, peak_mib=peak_mb,
                          mean_features=float(feats.mean()),
                          mean_matches=float(matches[1:].mean()),
                          mean_inliers=float(inliers[1:].mean()))


def drive_frames(pipe, frames, imu, read):
    """Feed `frames` at FPS with their IMU samples in (t_prev, ts] to an
    online pipeline, each step ended by a synchronise. -> (step ms,
    read(pipe.last_output) a frame)."""
    imu_t, imu_a, imu_g = imu
    step_ms, outs, t_prev = [], [], -np.inf
    for k, img in enumerate(frames):
        ts = k / FPS
        for j in np.nonzero((imu_t > t_prev) & (imu_t <= ts))[0]:
            pipe.process_imu(imu_t[j], imu_a[j], imu_g[j])
        t0 = time.perf_counter()
        pipe.process_frame(img, ts)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(read(pipe.last_output))
        t_prev = ts
    return step_ms, outs


def profile_slice(frames, imu, cam, n: int = 5):
    """Where a steady frame step's time goes: torch.profiler over n frames
    after warm-up. Returns wall ms per frame, device-busy ms per frame
    (the sum of kernel and copy durations on the card), device launches
    per frame, and the costliest operators by host and device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aria_slam_tpu_torch.config import PipelineConfig
    from aria_slam_tpu_torch.pipeline import factory

    pipe = factory.create_gpu(PipelineConfig(camera=cam, enable_fusion=False,
                                             enable_loop_closure=False, enable_mapping=False))
    imu_t, imu_a, imu_g = imu
    t_prev = -np.inf

    def feed(k):
        nonlocal t_prev
        ts = k / FPS
        for j in np.nonzero((imu_t > t_prev) & (imu_t <= ts))[0]:
            pipe.process_imu(imu_t[j], imu_a[j], imu_g[j])
        pipe.process_frame(frames[k], ts)
        t_prev = ts

    for k in range(3):
        feed(k)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for k in range(3, 3 + n):
            feed(k)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3 / n
    table = prof.key_averages()
    top_host = sorted(table, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    top_dev = sorted((e for e in table if e.self_device_time_total > 0),
                     key=lambda e: e.self_device_time_total, reverse=True)[:12]
    rec = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, device_events_per_frame=len(dev) / n,
               top_host_ms=[(e.key, e.self_cpu_time_total / 1e3 / n, e.count / n)
                            for e in top_host],
               top_device_ms=[(e.key, e.self_device_time_total / 1e3 / n, e.count / n)
                              for e in top_dev])
    log("profile", f"{n} steady frames: wall {wall_ms:.2f} ms/frame, device busy "
                   f"{busy_ms:.3f} ms/frame ({100 * busy_ms / wall_ms:.2f} %), "
                   f"{len(dev) / n:.0f} device kernels+copies per frame; top host ops "
                   + ", ".join(f"{k} {ms:.1f} ms x{c:.0f}" for k, ms, c in rec["top_host_ms"][:6]))
    return rec


# --------------------------------------------------------------- chunked
def chunked_inputs(frames, imu):
    """uint8 frame stack, timestamps and per-pair gyro rotation priors of
    the chunked run."""
    from aria_slam_tpu_torch.fusion import gyro_prior

    ts = np.arange(len(frames)) / FPS
    gyro_R, gyro_ok = gyro_prior.pair_rotations(imu[0], imu[2], ts)
    return np.stack(frames).astype(np.uint8), ts, gyro_R, gyro_ok


def chunked_config(cam):
    """The odometry path of the chunked evaluator: every default, the
    wide-baseline scale correction on (as the accuracy benchmark sets
    it), loop closure and mapping off."""
    from aria_slam_tpu_torch.config import PipelineConfig

    return PipelineConfig(camera=cam, enable_loop_closure=False, enable_mapping=False,
                          enable_detection=False, vo_backbone_scale=True)


def feed_chunk(slam, k, stack, ts, gyro_R, gyro_ok, imu):
    s = k * CHUNK
    slam.process_chunk(stack[s:s + CHUNK + 1], ts[s:s + CHUNK + 1], gyro_R[s:s + CHUNK],
                       gyro_ok[s:s + CHUNK], imu)


def run_chunked(frames, gt, imu, cam):
    from aria_slam_tpu_torch.eval import metrics
    from aria_slam_tpu_torch.eval.chunked import ChunkedSlam
    from aria_slam_tpu_torch.ops.cuda import corner_kernel, match_kernel, patch_kernel
    from aria_slam_tpu_torch.utils.profiling import StageTimer

    kernels = (corner_kernel.corner_rank_maps, patch_kernel.extract_patches_levels,
               match_kernel.match_top2_batched)
    stack, ts, gyro_R, gyro_ok = chunked_inputs(frames, imu)
    timer = StageTimer(device="cuda")
    slam = ChunkedSlam(chunked_config(cam), chunk=CHUNK, seed=0, timer=timer)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    for k in kernels:
        k.launches = 0
    chunk_ms, ok = [], []
    for k in range(NUM_CHUNKS):
        t0 = time.perf_counter()
        feed_chunk(slam, k, stack, ts, gyro_R, gyro_ok, imu)
        torch.cuda.synchronize()
        chunk_ms.append((time.perf_counter() - t0) * 1e3)
        ok.append(slam.last_ok)
    launches = {k.__name__: k.launches for k in kernels}
    t0 = time.perf_counter()
    slam.finalize()
    torch.cuda.synchronize()
    fin_ms = (time.perf_counter() - t0) * 1e3
    peak_mb = torch.cuda.max_memory_allocated() / 2**20

    est = np.stack([T[:3, 3] for _, T in slam.trajectory])
    ate = metrics.ate_rmse(est, gt)
    ok_share = float(np.concatenate(ok).mean())
    stages = timer.summary()
    steady_ms = float(np.mean(chunk_ms[1:]))
    log("chunked", f"{len(frames)} frames {cam.width}x{cam.height} in {NUM_CHUNKS} chunks of "
                   f"{CHUNK}: chunk ms {', '.join(f'{m:.1f}' for m in chunk_ms)} (first apart); "
                   f"steady {steady_ms:.1f} ms a chunk, {steady_ms / CHUNK:.2f} ms a frame; "
                   "stages, steady mean ms (first chunk): "
                   + "; ".join(f"{n} {v['mean_ms']:.1f} ({v['warm_ms']:.1f})"
                               for n, v in sorted(stages.items()))
                   + f"; finalize {fin_ms:.1f} ms; pairs ok {ok_share:.3f}; IMU correction "
                     f"{slam._imu_corr:.4f}, lag-pin factor {slam._vis_local:.4f}; Sim3 ATE "
                     f"{ate:.4f} m; peak memory {peak_mb:.1f} MiB ({base_mb:.1f} MiB held "
                     f"before); launches {launches}")
    want = {"corner_rank_maps": NUM_CHUNKS, "extract_patches_levels": NUM_CHUNKS,
            "match_top2_batched": 2 * NUM_CHUNKS}
    if launches != want:
        raise AssertionError(f"chunked launch counts {launches}, expected {want}")
    if not ok_share >= 0.9:
        raise AssertionError(f"share of pairs that succeeded {ok_share:.3f} < 0.9")
    if est.shape != gt.shape or not np.isfinite(est).all():
        raise AssertionError("chunked trajectory has a wrong shape or a non-finite pose")
    if not ate < 0.35:
        raise AssertionError(f"chunked Sim3 ATE {ate} m (limit 0.35 m)")
    return launches, dict(chunk_ms=chunk_ms, ms_per_frame=steady_ms / CHUNK, stages=stages,
                          finalize_ms=fin_ms, ate_m=ate, pairs_ok=ok_share,
                          imu_corr=slam._imu_corr, vis_local=slam._vis_local,
                          peak_mib=peak_mb)


def profile_chunked(frames, imu, cfg, nchunks: int, label: str):
    """The last of `nchunks` chunks under torch.profiler: wall ms, the
    card's busy ms, device kernels and copies, cudaLaunchKernel calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aria_slam_tpu_torch.eval.chunked import ChunkedSlam
    from aria_slam_tpu_torch.ops.cuda import match_kernel

    stack, ts, gyro_R, gyro_ok = chunked_inputs(frames, imu)
    slam = ChunkedSlam(cfg, chunk=CHUNK, seed=0)
    for k in range(nchunks - 1):
        feed_chunk(slam, k, stack, ts, gyro_R, gyro_ok, imu)
    torch.cuda.synchronize()
    match_kernel.match_top2_batched.launches = 0
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        feed_chunk(slam, nchunks - 1, stack, ts, gyro_R, gyro_ok, imu)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    match_launches = match_kernel.match_top2_batched.launches
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    table = prof.key_averages()
    launch = [e for e in table if e.key == "cudaLaunchKernel"]
    n_launch = int(launch[0].count) if launch else 0
    launch_host_ms = launch[0].self_cpu_time_total / 1e3 if launch else 0.0
    top_dev = sorted((e for e in table if e.self_device_time_total > 0),
                     key=lambda e: e.self_device_time_total, reverse=True)[:12]
    top_host = sorted(table, key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    rec = dict(wall_ms=wall_ms, device_busy_ms=busy_ms, device_events=len(dev),
               cuda_launch_kernel_calls=n_launch, cuda_launch_kernel_host_ms=launch_host_ms,
               match_launches=match_launches,
               top_device_ms=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top_dev],
               top_host_ms=[(e.key, e.self_cpu_time_total / 1e3, e.count) for e in top_host])
    log("profile", f"{label}, one steady chunk of {CHUNK} (chunk {nchunks}, {match_launches} "
                   f"match launches): wall {wall_ms:.1f} ms "
                   f"({wall_ms / CHUNK:.2f} ms a frame), device busy {busy_ms:.2f} ms "
                   f"({100 * busy_ms / wall_ms:.2f} %), {len(dev)} device kernels+copies, "
                   f"{n_launch} cudaLaunchKernel calls ({launch_host_ms:.1f} ms of host time); "
                   "top device ops "
                   + ", ".join(f"{k} {ms:.2f} ms x{c}" for k, ms, c in rec["top_device_ms"][:6]))
    return rec


# ------------------------------------------------------------------ loop
def benchmark_config(cam, loop_closure: bool = True):
    """The accuracy benchmark's full-resolution configuration for
    LOOP_FRAMES frames (the port's eval/accuracy_benchmark.benchmark_config,
    as the JAX package's: mapping into a 100,000-point map, fusion on for
    euroc_eval) at camera `cam`, loop closure on or off."""
    import dataclasses

    from aria_slam_tpu_torch.eval.accuracy_benchmark import benchmark_config as bench

    return dataclasses.replace(bench(full_res=True, frames=LOOP_FRAMES), camera=cam,
                               enable_loop_closure=loop_closure)


def run_loop(frames, gt, imu, cam):
    """The loop phase. Returns the launch counts, the record, and the
    inputs of the match kernel's last verify launch (on the host)."""
    from aria_slam_tpu_torch.backend import loop_closure
    from aria_slam_tpu_torch.eval import chunked, metrics
    from aria_slam_tpu_torch.ops.cuda import corner_kernel, match_kernel, patch_kernel
    from aria_slam_tpu_torch.utils.profiling import StageTimer

    kernels = (corner_kernel.corner_rank_maps, patch_kernel.extract_patches_levels,
               match_kernel.match_top2_batched)
    stack, ts, gyro_R, gyro_ok = chunked_inputs(frames, imu)
    timer = StageTimer(device="cuda")
    slam = chunked.ChunkedSlam(benchmark_config(cam), chunk=CHUNK, seed=0, timer=timer)
    # the match kernel's launches inside lc_query and verify_batch, read
    # from its counter around each call, and the verify batch's inputs,
    # copied into pinned host buffers on the stream (no wait, and no
    # device memory held, so the peak stays the run's own)
    match_launches = {"query": 0, "verify": 0}
    vm, nf = max(chunked.VERIFY_MAX, CHUNK), slam.cfg.orb.num_features
    verify_args = [torch.empty((vm, nf, 256), dtype=torch.int8, pin_memory=True),
                   torch.empty((vm, nf, 256), dtype=torch.int8, pin_memory=True),
                   torch.empty((vm, nf), dtype=torch.bool, pin_memory=True)]

    in_verify = [False]  # the candidate scores launch the same wrapper

    def counted(fn, role):
        def call(*a, **kw):
            before = match_kernel.match_top2_batched.launches
            in_verify[0] = role == "verify"
            try:
                out = fn(*a, **kw)
            finally:
                in_verify[0] = False
            match_launches[role] += match_kernel.match_top2_batched.launches - before
            return out
        return call

    wrapper = loop_closure.match_top2_batched

    def recorded(*a):
        out = wrapper(*a)
        if in_verify[0]:
            for host, x in zip(verify_args, a):
                host.copy_(x, non_blocking=True)
        return out

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    for k in kernels:
        k.launches = 0
    chunk_ms = []
    with contextlib.ExitStack() as patches:
        for mod, name, fn in ((chunked, "lc_query", counted(chunked.lc_query, "query")),
                              (chunked, "verify_batch", counted(chunked.verify_batch, "verify")),
                              (loop_closure, "match_top2_batched", recorded)):
            patches.enter_context(mock.patch.object(mod, name, fn))
        for k in range(LOOP_CHUNKS):
            t0 = time.perf_counter()
            feed_chunk(slam, k, stack, ts, gyro_R, gyro_ok, imu)
            torch.cuda.synchronize()
            chunk_ms.append((time.perf_counter() - t0) * 1e3)
    launches = {k.__name__: k.launches for k in kernels}
    t0 = time.perf_counter()
    slam.finalize()
    torch.cuda.synchronize()
    fin_ms = (time.perf_counter() - t0) * 1e3
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    stages = timer.summary()
    n_verified = stages.get("loop_verify", {}).get("count", 0)
    map_count, map_live = int(slam.map_state.count), int(slam.get_map().valid.sum())

    est = np.stack([T[:3, 3] for _, T in slam.trajectory])
    ate = metrics.ate_rmse(est, gt)
    pairs = slam.loop_pairs
    true = [(i, j) for i, j in pairs if np.linalg.norm(gt[i] - gt[j]) < LOOP_TRUE_M]
    precision = len(true) / max(len(pairs), 1)

    # the same frames with loop closure off: the no-harm reference
    off = chunked.ChunkedSlam(benchmark_config(cam, loop_closure=False), chunk=CHUNK, seed=0)
    for k in range(LOOP_CHUNKS):
        feed_chunk(off, k, stack, ts, gyro_R, gyro_ok, imu)
    off.finalize()
    ate_off = metrics.ate_rmse(np.stack([T[:3, 3] for _, T in off.trajectory]), gt)

    steady_ms = float(np.mean(chunk_ms[1:]))
    log("loop", f"{len(frames)} frames {cam.width}x{cam.height} (rotloop, {LOOP_PERIOD:g} s "
                f"period) in {LOOP_CHUNKS} chunks of {CHUNK}, loop closure on: chunk ms "
                f"{', '.join(f'{m:.1f}' for m in chunk_ms)} (first apart); steady "
                f"{steady_ms:.1f} ms a chunk, {steady_ms / CHUNK:.2f} ms a frame; stages, steady "
                "mean ms (first) x count: "
                + "; ".join(f"{n} {v['mean_ms']:.1f} ({v['warm_ms']:.1f}) x{v['count']}"
                            for n, v in sorted(stages.items()))
                + f"; finalize {fin_ms:.1f} ms; state_update (with the map insert) "
                  f"{stages['state_update']['mean_ms']:.2f} ms; map {map_count} points inserted, "
                  f"{map_live} after the outlier filter; peak memory {peak_mb:.1f} MiB (1716.7 "
                  f"MiB before the map was ported; {base_mb:.1f} MiB held before); loops {len(pairs)}, {len(true)} true (within {LOOP_TRUE_M} m), "
                  f"precision {precision:.3f}, frames {sorted({j for _, j in pairs})}; Sim3 ATE "
                  f"{ate:.4f} m with loop closure, {ate_off:.4f} m without; launches {launches}, "
                  f"match in lc_query / verify_batch {match_launches} ({n_verified} chunks "
                  "verified)")
    # a chunk: the front end's 2 match launches and lc_query's 1; one
    # verify_batch launch a chunk that verified
    want = {"corner_rank_maps": LOOP_CHUNKS, "extract_patches_levels": LOOP_CHUNKS,
            "match_top2_batched": 3 * LOOP_CHUNKS + n_verified}
    want_match = {"query": LOOP_CHUNKS, "verify": n_verified}
    if launches != want or match_launches != want_match:
        raise AssertionError(f"loop launch counts {launches}, match in lc_query / verify_batch "
                             f"{match_launches}; expected {want}, {want_match}")
    if not n_verified:
        raise AssertionError("no chunk verified candidates")
    if not pairs or precision < 0.9:
        raise AssertionError(f"loops {pairs}: {len(true)} true, precision {precision:.3f}")
    if est.shape != gt.shape or not np.isfinite(est).all():
        raise AssertionError("loop trajectory has a wrong shape or a non-finite pose")
    if not ate <= 1.15 * ate_off + 0.02:
        raise AssertionError(f"loop closure harms: ATE {ate} m with, {ate_off} m without")
    if not 0 < map_live <= map_count:
        raise AssertionError(f"map of {map_count} points, {map_live} live")
    return launches, dict(chunk_ms=chunk_ms, ms_per_frame=steady_ms / CHUNK, stages=stages,
                          finalize_ms=fin_ms, peak_mib=peak_mb, loops=len(pairs),
                          map_points=map_count, map_live=map_live,
                          true_loops=len(true), precision=precision, loop_pairs=pairs,
                          ate_m=ate, ate_without_loops_m=ate_off,
                          match_launches=match_launches), verify_args


# ------------------------------------------------------------------ eval
def _ply_points(path: str) -> int:
    with open(path) as f:
        lines = f.read().splitlines()
    return len(lines) - lines.index("end_header") - 1


def decode_chunk_ms(paths) -> dict:
    """One chunk's PNGs (CHUNK + 1) decoded alone, in this process and as
    the evaluator's worker decodes them (split over its child
    processes): the median of 3 each, ms."""
    from aria_slam_tpu_torch.eval import euroc_eval
    from aria_slam_tpu_torch.io import euroc

    out = {}
    with euroc.DecodeProcesses(euroc_eval.DECODE_PROCESSES) as children:
        for name, fn in (("in this process", euroc.load_images_safe),
                         (f"in {euroc_eval.DECODE_PROCESSES} children", children)):
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                imgs = fn(paths[:CHUNK + 1])
                times.append((time.perf_counter() - t0) * 1e3)
                if any(img is None for img in imgs):
                    raise AssertionError("a generated frame does not decode")
            out[name] = float(np.median(times))
    return out


def adaptive_pngs(paths):
    """Rewrite every frame with libpng's choice of row filter; -> (one
    chunk's decode alone as decode_chunk_ms times it, rows of each filter
    type 0-4, seconds)."""
    from aria_slam_tpu_torch.io import euroc

    t0 = time.perf_counter()
    filters = np.zeros(5, np.int64)
    for path in paths:
        img = euroc.load_image(path)
        data = euroc.encode_png_gray8(img, adaptive=True)
        filters += np.bincount(euroc.inflate_png(data)[1], minlength=5)
        with open(path, "wb") as f:
            f.write(data)
    enc_s = time.perf_counter() - t0
    ms = decode_chunk_ms(paths)
    if not np.array_equal(euroc.load_image(paths[-1]), img):
        raise AssertionError("a rewritten frame decodes to other pixels")
    return ms, filters.tolist(), enc_s


def run_eval(cam, tmp):
    """The eval phase: the port's generate() writes the full-resolution
    rotloop (LOOP_FRAMES frames, the loop phase's trajectory, 200 Hz IMU)
    as an ASL directory under `tmp` (tmp/rotloop, libpng's row filters at
    the end, for the online phase), and the port's euroc_eval.run reads it at chunk
    CHUNK in the accuracy benchmark's three variants (vo: fusion and loop
    closure off; vio: loop closure off; vio_lc: all on). Each variant runs
    with the kernels' counts set to 0 just before it and read just after.
    The EKF of vio_lc is timed once more on the other device."""
    import dataclasses

    from aria_slam_tpu_torch.eval import euroc_eval
    from aria_slam_tpu_torch.fusion import ekf
    from aria_slam_tpu_torch.io import euroc, synthetic_scene
    from aria_slam_tpu_torch.ops.cuda import corner_kernel, match_kernel, patch_kernel
    from aria_slam_tpu_torch.utils.profiling import StageTimer

    kernels = (corner_kernel.corner_rank_maps, patch_kernel.extract_patches_levels,
               match_kernel.match_top2_batched)
    cfg = benchmark_config(cam)
    variants = {"vo": dataclasses.replace(cfg, enable_fusion=False, enable_loop_closure=False),
                "vio": dataclasses.replace(cfg, enable_loop_closure=False),
                "vio_lc": cfg}
    gt = np.stack([synthetic_scene.trajectory(k / FPS, kind="rotloop", period=LOOP_PERIOD)[0]
                   for k in range(LOOP_FRAMES)])
    rec, launches = {}, {}
    scene = f"{tmp}/rotloop"
    t0 = time.perf_counter()
    synthetic_scene.generate(scene, num_frames=LOOP_FRAMES, fps=FPS, cam=cam, depth=4.0,
                             traj="rotloop", period=LOOP_PERIOD)
    gen_s = time.perf_counter() - t0
    log("eval", f"generate(): {LOOP_FRAMES} rotloop frames {cam.width}x{cam.height}, "
                f"rendered and written as PNG with the IMU and ground truth, in {gen_s:.1f} s")
    paths = euroc.load(scene).image_paths
    decode_alone = {"filter 0": decode_chunk_ms(paths)}
    for name, vcfg in variants.items():
        if name == "vio":
            decode_alone["libpng's filters"], filters, enc_s = adaptive_pngs(paths)
            log("eval", f"frames rewritten with libpng's row filters in {enc_s:.1f} s; rows "
                        "None / Sub / Up / Average / Paeth: " + " / ".join(map(str, filters))
                        + "; one chunk's decode alone (" + str(CHUNK + 1) + " PNGs, median "
                        "of 3): " + "; ".join(f"{k}: " + ", ".join(
                            f"{where} {ms:.1f} ms" for where, ms in v.items())
                            for k, v in decode_alone.items()))
            if not (filters[3] and filters[4]):
                raise AssertionError("the rewritten frames hold no Average or Paeth rows")
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        res = euroc_eval.run(scene, out_dir=f"{tmp}/{name}", config=vcfg, verbose=False,
                             chunk=CHUNK, keep_pipe=True)
        wall_s = time.perf_counter() - t0
        launches[name] = {k.__name__: k.launches for k in kernels}
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        pipe = res.pop("_pipe")
        est = np.stack([T[:3, 3] for _, T in pipe.trajectory])
        pairs = pipe.loop_pairs
        true = [(i, j) for i, j in pairs if np.linalg.norm(gt[i] - gt[j]) < LOOP_TRUE_M]
        precision = len(true) / max(len(pairs), 1)
        ply = _ply_points(f"{tmp}/{name}/map.ply")
        n_verified = res["stage_n"].get("loop_verify", 0)
        rec[name] = dict(res, wall_s=wall_s, peak_mib=peak_mb, precision=precision,
                         true_loops=len(true), ply_points=ply, loop_pairs=pairs)
        fused = ", ".join(f"{k} {res[k]:.4f}" for k in (
            "ate_fused_rmse_m", "ate_fused_noscale_rmse_m", "ate_fused_raw_rmse_m") if k in res)
        log("eval", f"{name}: {res['frames']} frames in {wall_s:.1f} s; ATE Sim3 "
                    f"{res['ate_rmse_m']:.4f} m, no-scale {res['ate_noscale_rmse_m']:.4f} m, "
                    f"raw {res['ate_raw_rmse_m']:.4f} m; fused {fused or 'none (fusion off)'}"
                    f"; umeyama_scale {res['umeyama_scale']:.4f}; rpe_rot "
                    f"{res['rpe_rot_deg']:.4f} deg; loops {res['loops']} ({len(true)} true, "
                    f"precision {precision:.3f}); map_points {res['map_points']} (map.ply "
                    f"{ply}); steady_frame_ms {res['steady_frame_ms']:.2f}; avg_fps "
                    f"{res['avg_fps']:.2f}; compile_wall_s {res['compile_wall_s']}; peak "
                    f"memory {peak_mb:.1f} MiB; launches {launches[name]}; decode "
                    f"{res['stage_ms']['decode']:.1f} ms a chunk on the worker against "
                    f"device_chunk {res['stage_ms']['device_chunk']:.1f} ms, the main "
                    f"thread's decode_wait {res['stage_ms']['decode_wait']:.1f} ms a chunk "
                    f"(first {res['stage_ms_warm']['decode_wait']:.1f} ms); stage_ms (n): "
                    + "; ".join(f"{k} {v} ({res['stage_n'][k]})"
                                for k, v in sorted(res["stage_ms"].items())))
        want = {"corner_rank_maps": LOOP_CHUNKS, "extract_patches_levels": LOOP_CHUNKS,
                "match_top2_batched": (3 * LOOP_CHUNKS + n_verified if vcfg.enable_loop_closure
                                       else 2 * LOOP_CHUNKS)}
        if launches[name] != want:
            raise AssertionError(f"eval {name} launch counts {launches[name]}, expected {want}")
        if est.shape != gt.shape or not np.isfinite(est).all():
            raise AssertionError(f"eval {name}: a wrong shape or a non-finite pose")
        if ply != res["map_points"] or res["map_points"] <= 0:
            raise AssertionError(f"eval {name}: map.ply holds {ply} points, map_points "
                                 f"{res['map_points']}")
        if vcfg.enable_fusion and not (
                res["ate_fused_rmse_m"] <= res["ate_rmse_m"] + 1e-3
                and res["ate_fused_raw_rmse_m"] <= res["ate_raw_rmse_m"] + 1e-3):
            raise AssertionError(f"eval {name}: the fused track is worse than the chain")
    lc = rec["vio_lc"]
    if not lc["loops"] or lc["precision"] < 0.9:
        raise AssertionError(f"eval vio_lc: loops {lc['loop_pairs']}, precision "
                             f"{lc['precision']:.3f}")
    if not lc["ate_rmse_m"] <= 1.15 * rec["vio"]["ate_rmse_m"] + 0.02:
        raise AssertionError(f"eval: loop closure harms, ATE {lc['ate_rmse_m']} m with, "
                             f"{rec['vio']['ate_rmse_m']} m without")

    # the EKF once more, on the device the evaluator does not use for it
    other = "cuda" if euroc_eval.EKF_DEVICE == "cpu" else "cpu"
    timer = StageTimer(device="cuda")
    data = euroc.load(scene)
    fused_other, _ = ekf.run_sequence(*euroc_eval.ekf_inputs(data, pipe.trajectory), cfg.ekf,
                                      smooth=True, device=other, timer=timer)
    fused_chosen = euroc_eval.fuse(data, pipe.trajectory, cfg)
    ekf_other = {k: v["mean_ms"] for k, v in timer.summary().items()}
    diff = float(np.abs(fused_other.cpu().numpy() - fused_chosen).max())
    chosen = {k: lc["stage_ms"][k] for k in ("ekf_forward", "ekf_smoother")}
    n_events = len(data.imu_ts) + LOOP_FRAMES
    log("eval", f"EKF over about {n_events} events on {euroc_eval.EKF_DEVICE} (the evaluator's "
                f"choice): forward {chosen['ekf_forward']:.1f} ms, smoother "
                f"{chosen['ekf_smoother']:.1f} ms; on {other}: forward "
                f"{ekf_other['ekf_forward']:.1f} ms, smoother {ekf_other['ekf_smoother']:.1f} ms; "
                f"fused positions of the two routes within {diff:.2e} m. Direction only, TPU: "
                "PREFETCH_r05.json, 240 frames, vio_lc at chunk 32, 57 loops, Sim3 ATE 0.1795 m")
    return launches, dict(variants=rec, generate_s=gen_s, decode_alone_ms=decode_alone,
                          png_row_filters=filters, ekf_chosen_ms=chosen,
                          ekf_other_device=other, ekf_other_ms=ekf_other,
                          ekf_route_max_diff_m=diff)


# ---------------------------------------------------------------- online
ONLINE_BENCH_FRAMES = 24  # online_benchmark's frames a mode (4 of them warm-up)
LAZY_DEPTH = 3


def _timed(owner, name: str, times: list):
    """mock.patch.object(owner, name) with a wrapper that appends the
    call's ms, ended by a synchronise, to `times`."""
    fn = getattr(owner, name)

    def call(*a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        return out
    return mock.patch.object(owner, name, call)


def ekf_route_ms(calls, cfg_ekf) -> dict:
    """The online EKF's frame steps of a run (`calls`: the arguments
    ekf.frame_step received, host tensors) replayed in order on the host
    and on the card -> ms a frame on each, and the largest gap between
    the two routes' final positions."""
    from aria_slam_tpu_torch.fusion import ekf

    out, final = {}, {}
    for dev in ("cpu", "cuda"):
        state = ekf.init_state(device=dev)
        consts = ekf._Consts(cfg_ekf, torch.float32, torch.device(dev))
        args = [[x.to(dev) if isinstance(x, torch.Tensor) else x for x in a[1:]] for a in calls]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for a in args:
            state = ekf.frame_step(state, *a[:8], cfg_ekf, consts)
        torch.cuda.synchronize()
        out[dev] = (time.perf_counter() - t0) * 1e3 / len(calls)
        final[dev] = state.pos.cpu().numpy()
    return dict(ms_a_frame=out, max_diff_m=float(np.abs(final["cpu"] - final["cuda"]).max()))


def run_online(cam, tmp, gt, chunked_lc):
    """The online phase: the port's default online entry point on the eval
    phase's rotloop directory (libpng-filtered PNGs). (1) euroc_eval.run
    with chunk=0 in the accuracy benchmark's vio_lc configuration (fusion,
    loop closure, mapping), with the kernels' counts set to 0 just before
    it and read just after (the match kernel's also by role: inside
    loop_closure._full_scores, the N = 8 candidate scores, and inside
    verify_candidate, the N = 5 verify); frame steps timed with and
    without a verify, each loop's optimisation, finalize, and the EKF's
    frame steps replayed on both routes. (2) euroc_eval.run with
    PipelineConfig() as it is (512-keyframe DB, 200,000-point map,
    4096-node graph) on the first 40 frames. (3) online_benchmark.run_mode
    in sync and in lazy mode on ONLINE_BENCH_FRAMES full-width frames."""
    from aria_slam_tpu_torch.backend import loop_closure
    from aria_slam_tpu_torch.config import PipelineConfig
    from aria_slam_tpu_torch.eval import euroc_eval, metrics, online_benchmark
    from aria_slam_tpu_torch.fusion import ekf
    from aria_slam_tpu_torch.ops.cuda import corner_kernel, match_kernel, patch_kernel
    from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline

    kernels = (corner_kernel.corner_rank_maps, patch_kernel.extract_patches_levels,
               match_kernel.match_top2_batched)
    scene = f"{tmp}/rotloop"
    cfg = benchmark_config(cam)
    match_launches = {"query": 0, "verify": 0}

    def counted(fn, role):
        def call(*a, **kw):
            before = match_kernel.match_top2_batched.launches
            out = fn(*a, **kw)
            match_launches[role] += match_kernel.match_top2_batched.launches - before
            return out
        return call

    step_ms, verify_flags, loop_ms, fin_ms, ekf_calls, published = [], [], [], [], [], []
    process_frame = SlamPipeline.process_frame

    def frame(self, *a):
        before = match_launches["verify"]
        t0 = time.perf_counter()
        pose = process_frame(self, *a)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        verify_flags.append(match_launches["verify"] > before)
        published.append(pose[:3, 3])
        return pose

    frame_step = ekf.frame_step

    def recorded_ekf(*a):
        ekf_calls.append(a)
        return frame_step(*a)

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    with contextlib.ExitStack() as patches:
        for owner, name, fn in (
                (loop_closure, "_full_scores", counted(loop_closure._full_scores, "query")),
                (loop_closure, "verify_candidate",
                 counted(loop_closure.verify_candidate, "verify")),
                (SlamPipeline, "process_frame", frame), (ekf, "frame_step", recorded_ekf)):
            patches.enter_context(mock.patch.object(owner, name, fn))
        patches.enter_context(_timed(SlamPipeline, "_handle_loop", loop_ms))
        patches.enter_context(_timed(SlamPipeline, "finalize", fin_ms))
        res = euroc_eval.run(scene, out_dir=f"{tmp}/online", config=cfg, verbose=False,
                             chunk=0, keep_pipe=True)
    wall_s = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    pipe = res.pop("_pipe")
    est = np.stack([T[:3, 3] for _, T in pipe.trajectory])
    pairs = pipe.loop_pairs
    true = [(i, j) for i, j in pairs if np.linalg.norm(gt[i] - gt[j]) < LOOP_TRUE_M]
    precision = len(true) / max(len(pairs), 1)
    ply = _ply_points(f"{tmp}/online/map.ply")
    steps = np.array(step_ms[1:])
    ver = np.array(verify_flags[1:])
    n = len(step_ms)
    # the chain as each frame published it (what the EKF consumed; the
    # final chain also has the later loops' and finalize's corrections)
    ate_published = metrics.ate_rmse(np.stack(published), gt)
    route = ekf_route_ms(ekf_calls, cfg.ekf)
    rec = dict(res, wall_s=wall_s, peak_mib=peak_mb, precision=precision, true_loops=len(true),
               loop_pairs=pairs, ply_points=ply, launches=launches,
               match_launches=dict(match_launches),
               steady_step_ms_median=float(np.median(steps)),
               steady_step_ms_p90=float(np.percentile(steps, 90)),
               step_ms_with_verify=float(np.median(steps[ver])) if ver.any() else None,
               step_ms_without_verify=float(np.median(steps[~ver])),
               frames_verified=int(ver.sum()), loop_optimize_ms=loop_ms,
               ate_published_m=ate_published,
               finalize_ms=fin_ms[0], ekf_route=route)
    fused = ", ".join(f"{k} {res[k]:.4f}" for k in (
        "ate_fused_rmse_m", "ate_fused_noscale_rmse_m", "ate_fused_raw_rmse_m"))
    log("online", f"euroc_eval.run chunk=0, vio_lc configuration: {res['frames']} frames in "
                  f"{wall_s:.1f} s; ATE Sim3 {res['ate_rmse_m']:.4f} m, no-scale "
                  f"{res['ate_noscale_rmse_m']:.4f} m, raw {res['ate_raw_rmse_m']:.4f} m, the "
                  f"chain as published frame by frame Sim3 {ate_published:.4f} m; fused "
                  f"{fused}; loops {len(pairs)} ({len(true)} true within {LOOP_TRUE_M} m, "
                  f"precision {precision:.3f}), frames {sorted({j for _, j in pairs})}; "
                  f"map_points {res['map_points']} (map.ply {ply}); steady_frame_ms "
                  f"{res['steady_frame_ms']:.2f}; frame step ms median {np.median(steps):.2f} "
                  f"p90 {np.percentile(steps, 90):.2f}, without a verify "
                  f"{rec['step_ms_without_verify']:.2f}, with one "
                  f"{rec['step_ms_with_verify'] or float('nan'):.2f} ({int(ver.sum())} frames); "
                  f"loop_optimize ms "
                  f"{', '.join(f'{m:.1f}' for m in loop_ms) or 'none'}; finalize "
                  f"{fin_ms[0]:.1f} ms; EKF ms a frame on the host "
                  f"{route['ms_a_frame']['cpu']:.2f} (the pipeline's route), on the card "
                  f"{route['ms_a_frame']['cuda']:.2f}, positions within "
                  f"{route['max_diff_m']:.2e} m; launches {launches} ({', '.join(f'{k} {v / n:.2f}' for k, v in launches.items())} a frame), "
                  f"match in _full_scores / verify_candidate {match_launches}; peak memory "
                  f"{peak_mb:.1f} MiB; stage_ms {res['stage_ms']}. Direction only: the chunked "
                  f"vio_lc of the eval phase, Sim3 {chunked_lc['ate_rmse_m']:.4f} m, fused "
                  f"{chunked_lc['ate_fused_rmse_m']:.4f} m, {chunked_lc['loops']} loops")
    want = {"corner_rank_maps": n, "extract_patches_levels": n,
            "match_top2_batched": 2 * n + match_launches["verify"]}
    if launches != want or match_launches["query"] != n:
        raise AssertionError(f"online launch counts {launches}, match by role {match_launches}; "
                             f"expected {want} with {n} query launches")
    if est.shape != gt.shape or not np.isfinite(est).all():
        raise AssertionError("online: a wrong shape or a non-finite pose")
    if not pairs or precision < 0.9:
        raise AssertionError(f"online loops {pairs}: {len(true)} true, precision {precision:.3f}")
    # tests/test_pipeline.py's no-harm gate for the EKF, against the chain
    # it consumed: the published chain. The final chain also carries the
    # corrections that later loops and finalize made to earlier frames,
    # which a causal filter's past cannot have (printed beside it)
    if not res["ate_fused_rmse_m"] <= 1.1 * ate_published + 0.02:
        raise AssertionError(f"online fused Sim3 ATE {res['ate_fused_rmse_m']} m against the "
                             f"published chain's {ate_published} m")
    if ply != res["map_points"] or res["map_points"] <= 0:
        raise AssertionError(f"online map.ply holds {ply} points, map_points "
                             f"{res['map_points']}")
    if not route["max_diff_m"] < 1e-3:
        raise AssertionError(f"the EKF's routes disagree by {route['max_diff_m']} m")

    # (2) the default configuration as it is
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    dres = euroc_eval.run(scene, out_dir=f"{tmp}/online_default", max_frames=40, verbose=False,
                          chunk=0, keep_pipe=True)
    dwall = time.perf_counter() - t0
    dpipe = dres.pop("_pipe")
    dpeak = torch.cuda.max_memory_allocated() / 2**20
    dest = np.stack([T[:3, 3] for _, T in dpipe.trajectory])
    sizes = dict(keyframes=dpipe.state.db.desc.shape[0], map=dpipe.state.map_state.points.shape[0],
                 nodes=dpipe.state.graph.node_pose.shape[0])
    log("online", f"PipelineConfig() as it is ({sizes}): 40 frames in {dwall:.1f} s, "
                  f"steady_frame_ms {dres['steady_frame_ms']:.2f}, Sim3 ATE "
                  f"{dres['ate_rmse_m']:.4f} m, fused {dres['ate_fused_rmse_m']:.4f} m, map "
                  f"{dres['map_points']} points, loops {dres['loops']}; peak memory {dpeak:.1f} MiB")
    if dest.shape != (40, 3) or not np.isfinite(dest).all():
        raise AssertionError("PipelineConfig() online run: a wrong shape or a non-finite pose")
    rec["default_config"] = dict(dres, wall_s=dwall, peak_mib=dpeak, sizes=sizes)

    # (3) online_benchmark: sync against lazy
    bcfg = online_benchmark.bench_config(small=False)
    frames = online_benchmark.make_frames(bcfg, ONLINE_BENCH_FRAMES)
    sync_ms, sync = online_benchmark.run_mode(bcfg, frames, 0, keep_pipe=True)
    lazy_ms, lazy = online_benchmark.run_mode(bcfg, frames, LAZY_DEPTH, keep_pipe=True)
    gap = float(np.abs(np.stack([T for _, T in sync.trajectory])[:, :3, 3]
                       - np.stack([T for _, T in lazy.trajectory])[:, :3, 3]).max())
    log("online", f"online_benchmark.run_mode, {ONLINE_BENCH_FRAMES} frames (4 warm-up) at "
                  f"{cam.width}x{cam.height}, default configuration: sync {sync_ms:.2f} ms a "
                  f"frame, lazy (depth {LAZY_DEPTH}) {lazy_ms:.2f} ms a frame, speedup "
                  f"{sync_ms / lazy_ms:.3f}; trajectories within {gap:.2e} m")
    if not gap <= 1e-5:
        raise AssertionError(f"lazy and sync trajectories differ by {gap} m")
    rec["online_benchmark"] = dict(sync_ms=sync_ms, lazy_ms=lazy_ms, lazy_depth=LAZY_DEPTH,
                                   frames=ONLINE_BENCH_FRAMES, max_gap_m=gap)
    return launches, rec


# ---------------------------------------------------------------- detect
BF16_OPS_PER_MS = 989e12 / 1e3
# the gate of parts (b) and (d): random weights score every anchor near
# 0.5, so at 0.9 they fire rarely (tests/test_chunked.py's choice)
DET_CONF = 0.9
# bf16 logits on the card against the port on the CPU: within this share
# of the level's largest |logit| (tests/test_torch_detector.py BF16_TOL)
DET_LOGIT_TOL = 0.03
MOVING_FRAMES = LOOP_FRAMES   # the moving-object scene: 8 chunks of 32 in part (d)
MOVING_ONLINE_FRAMES = 120    # part (c) reads the first 120 frames online
MIN_BOX_PX = 16               # part (c)'s gate counts boxes at least this wide and high


def conv_census(model):
    """Forward hooks on every convolution of `model`: a call's input dtype
    and cuDNN's TF32 flag at that moment, its operations (2 x MACs) and its
    unfused traffic (input, kernel and output once each). -> (records,
    handles); reset records["calls"] before a counted call."""
    from aria_slam_tpu_torch.models import yolo

    rec = {"calls": []}

    def hook(mod, inputs, out):
        x = inputs[0]
        k = mod.kernel
        rec["calls"].append(dict(
            dtype=str(x.dtype), tf32=bool(torch.backends.cudnn.allow_tf32),
            ops=2.0 * out.numel() * k.shape[1] * k.shape[2] * k.shape[3],
            nbytes=float(x.numel() * x.element_size() + k.numel() * k.element_size()
                         + out.numel() * out.element_size())))

    handles = [m.register_forward_hook(hook) for m in model.modules()
               if isinstance(m, yolo.Conv)]
    return rec, handles


def cuda_kernels(fn) -> int:
    """Kernels and copies the card ran for one call of fn (torch.profiler)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA)


def peak_mib(fn) -> float:
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return torch.cuda.max_memory_allocated() / 2**20


def run_detect_alone(frames, dev):
    """Part (a): the detector alone at YOLO-s width (DetectorConfig() as it
    is, 640 px, random weights from a seeded torch.Generator) on 752x480
    frames, B = 1 with NMS and B = 33 without, each piece timed."""
    import copy
    import dataclasses

    from aria_slam_tpu_torch.config import DetectorConfig
    from aria_slam_tpu_torch.models import detect, yolo
    from aria_slam_tpu_torch.ops import boxes

    cfg = DetectorConfig()
    cpu_model = yolo.init_model(cfg, torch.Generator().manual_seed(0))
    model = copy.deepcopy(cpu_model).to(dev).eval()
    census, handles = conv_census(model)
    h, w = frames[0].shape
    out = {"config": dataclasses.asdict(cfg)}
    single = detect.make_detector(cfg, model=model, device=dev)
    batched = detect.make_batched_detector(cfg, model=model, use_nms=False, device=dev)
    for b in (1, CHUNK + 1):
        imgs = torch.from_numpy(np.stack(frames[:b]).astype(np.float32)).to(dev)
        x = detect.preprocess(imgs, cfg.input_size)
        with torch.no_grad():
            census["calls"] = []
            outs = model(x)
        calls = list(census["calls"])
        bxs, scores = yolo.decode_predictions(outs, cfg.input_size, cfg.num_classes)
        post = detect._postprocess(bxs, scores, cfg, h, w, use_nms=False)
        whole = (lambda: single(imgs[0])) if b == 1 else (lambda: batched(imgs))
        with torch.no_grad():
            r = dict(
                ms=cuda_ms(whole, iters=10, warmup=3),
                preprocess_ms=cuda_ms(lambda: detect.preprocess(imgs, cfg.input_size), iters=10),
                forward_ms=cuda_ms(lambda: model(x), iters=10),
                forward_device_ms=graph_ms(lambda: model(x), iters=3 if b > 1 else 10,
                                           replays=3 if b > 1 else 5),
                decode_ms=cuda_ms(lambda: yolo.decode_predictions(outs, cfg.input_size,
                                                                  cfg.num_classes), iters=10),
                postprocess_ms=cuda_ms(lambda: detect._postprocess(bxs, scores, cfg, h, w,
                                                                   use_nms=False), iters=10))
        if b == 1:
            nms_args = (post.boxes[0], post.scores[0], post.valid[0], cfg.nms_iou_threshold)
            r["nms_ms"] = cuda_ms(lambda: boxes.nms(*nms_args), iters=5)
            r["nms_device_ms"] = graph_ms(lambda: boxes.nms(*nms_args), iters=2, replays=3)
            r["nms_kernels"] = cuda_kernels(lambda: boxes.nms(*nms_args))
        r["kernels"] = cuda_kernels(whole)
        r["peak_mib"] = peak_mib(whole)
        ops = sum(c["ops"] for c in calls)
        weights = sum(p.numel() * p.element_size() for p in model.parameters()) + sum(
            t.numel() * t.element_size() for t in model.buffers())
        d = cfg.max_detections
        min_bytes = imgs.numel() * 4 + weights + b * d * (4 * 4 + 4 + 4 + 1)
        b_ms, by = bound(min_bytes, ops, BF16_OPS_PER_MS)
        r.update(convs=len(calls), gflop=ops / 1e9, gflop_per_image=ops / b / 1e9,
                 min_bytes=min_bytes, unfused_conv_bytes=sum(c["nbytes"] for c in calls),
                 bound_ms=b_ms, bound_by=by,
                 unfused_bytes_ms=sum(c["nbytes"] for c in calls) / HBM_BYTES_PER_MS,
                 conv_dtypes=sorted({c["dtype"] for c in calls}),
                 conv_tf32=any(c["tf32"] and c["dtype"] == "torch.float32" for c in calls))
        out[f"B{b}"] = r
        log("detect", f"(a) YOLO-s {cfg.input_size} px, B={b} at {w}x{h}: whole call "
                      f"{r['ms']:.3f} ms ({'make_detector, NMS' if b == 1 else 'make_batched_detector, no NMS'}); "
                      f"preprocess {r['preprocess_ms']:.3f}, forward {r['forward_ms']:.3f} ms "
                      f"(device {r['forward_device_ms']:.3f} ms in a CUDA graph), decode "
                      f"{r['decode_ms']:.3f}, postprocess without NMS {r['postprocess_ms']:.3f}"
                      + (f", NMS {r['nms_ms']:.3f} ms (device {r['nms_device_ms']:.3f} ms, "
                         f"{r['nms_kernels']} kernels)" if b == 1 else "")
                      + f"; {r['kernels']} kernels and copies a call; {len(calls)} convs, "
                        f"{r['gflop_per_image']:.2f} GFLOP an image, bound {b_ms:.4f} ms "
                        f"({by}; unfused conv traffic {r['unfused_bytes_ms']:.4f} ms at HBM "
                        f"rate); peak {r['peak_mib']:.1f} MiB; conv input dtypes "
                        f"{r['conv_dtypes']}")
        if r["conv_dtypes"] != ["torch.bfloat16"] or r["conv_tf32"]:
            raise AssertionError(f"detector convs ran as {r['conv_dtypes']} (TF32 float32: "
                                 f"{r['conv_tf32']}); expected bf16")
    for hd in handles:
        hd.remove()

    # the same weights and frame through the port on the CPU
    img = torch.from_numpy(frames[0].astype(np.float32))
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu_outs = cpu_model(detect.preprocess(img, cfg.input_size))
        dev_outs = model(detect.preprocess(img.to(dev), cfg.input_size))
    cpu_s = time.perf_counter() - t0
    worst = 0.0
    for lvl, (co, do) in enumerate(zip(cpu_outs, dev_outs)):
        for c, g in zip(co, do):
            c, g = c.float(), g.float().cpu()
            err = float((c - g).abs().max() / c.abs().max())
            worst = max(worst, err)
    cb, cs = yolo.decode_predictions(cpu_outs, cfg.input_size, cfg.num_classes)
    gb, gs = yolo.decode_predictions(dev_outs, cfg.input_size, cfg.num_classes)
    # the gate 0.5 is logit 0: an anchor whose best class logit on the CPU
    # lies within the tolerance of 0 may fall either side
    cls_logits = torch.cat([o[1].float().permute(0, 2, 3, 1).reshape(-1, o[1].shape[1])
                            for o in cpu_outs])
    band = float(cls_logits.abs().max())
    ambiguous = cls_logits.amax(-1).abs() < DET_LOGIT_TOL * band
    gate_c = cs[0].amax(-1) >= cfg.conf_threshold
    gate_g = gs[0].amax(-1).cpu() >= cfg.conf_threshold
    gate_diff = int(((gate_c != gate_g) & ~ambiguous).sum())
    # the card's postprocess and NMS against the CPU's on the card's
    # decoded boxes and scores
    pd = detect._postprocess(gb[0], gs[0], cfg, h, w)
    pc = detect._postprocess(gb[0].cpu(), gs[0].cpu(), cfg, h, w)
    same = all(torch.equal(getattr(pd, f).cpu(), getattr(pc, f))
               for f in ("valid", "classes", "scores"))
    box_err = float((pd.boxes.cpu() - pc.boxes).abs().max())
    out["cpu_check"] = dict(max_rel_logit_err=worst, tol=DET_LOGIT_TOL, cpu_s=cpu_s,
                            gate_anchors=int(gate_c.sum()), ambiguous=int(ambiguous.sum()),
                            gate_diff=gate_diff, valid=int(pd.valid.sum()),
                            postprocess_equal=same, box_err=box_err)
    log("detect", f"(a) against the port on the CPU (same weights, frame 0; {cpu_s:.1f} s): "
                  f"logits within {worst:.4f} of each level's largest |logit| (tolerance "
                  f"{DET_LOGIT_TOL}); {int(gate_c.sum())} of {gate_c.numel()} anchors past the "
                  f"{cfg.conf_threshold} gate on the CPU, {gate_diff} differ outside the "
                  f"{int(ambiguous.sum())} within the tolerance of it; postprocess + NMS on the "
                  f"card's decoded output, card against CPU: valid / classes / scores equal "
                  f"{same}, boxes within {box_err:.2e} px, {int(pd.valid.sum())} valid")
    if not (worst <= DET_LOGIT_TOL and gate_diff == 0 and same and box_err <= 1e-3):
        raise AssertionError(f"detector on the card against the CPU: {out['cpu_check']}")
    return out


def run_detect_online(frames, gt, imu, cam, slice_rec):
    """Part (b): the online slice's 20 frames through factory.create_gpu
    with detection and dynamic filtering on (the slice's VO-only
    configuration plus the detector: YOLO-s, random weights, gate
    DET_CONF), counts set to 0 just before it; the VO-only configuration
    without the detector runs just before and just after it, since the
    host-bound steps drift over a long process (the slice phase's own
    steps are printed beside them)."""
    import dataclasses

    from aria_slam_tpu_torch.config import DetectorConfig, PipelineConfig
    from aria_slam_tpu_torch.eval import metrics
    from aria_slam_tpu_torch.models import detect
    from aria_slam_tpu_torch.ops.cuda import corner_kernel, match_kernel, patch_kernel
    from aria_slam_tpu_torch.pipeline import factory

    kernels = (corner_kernel.corner_rank_maps, patch_kernel.extract_patches_levels,
               match_kernel.match_top2_batched)
    det_cfg = dataclasses.replace(DetectorConfig(), conf_threshold=DET_CONF)
    vo_cfg = PipelineConfig(camera=cam, enable_fusion=False, enable_loop_closure=False,
                            enable_mapping=False)
    cfg = dataclasses.replace(vo_cfg, enable_detection=True, enable_dynamic_filtering=True,
                              detector=det_cfg)
    built, spans = [], []
    make = detect.make_detector

    def capture(*a, **kw):
        det = make(*a, **kw)

        def timed(image):
            s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            s.record()
            out = det(image)
            e.record()
            spans.append((s, e))
            return out

        built.append(det)
        return timed

    with mock.patch.object(detect, "make_detector", capture):
        pipe = factory.create_gpu(cfg)
    vo_ms = [drive_frames(factory.create_gpu(vo_cfg), frames, imu, lambda o: None)[0]]
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    step_ms, outs = drive_frames(pipe, frames, imu, lambda o: (
        int(o.num_matches), int(o.num_filtered), bool(o.vo_success),
        int(o.detections.valid.sum())))
    launches = {k.__name__: k.launches for k in kernels}
    peak_mb = torch.cuda.max_memory_allocated() / 2**20
    det_ms = [s.elapsed_time(e) for s, e in spans]
    vo_ms.append(drive_frames(factory.create_gpu(vo_cfg), frames, imu, lambda o: None)[0])
    pipe.finalize()
    est = np.stack([T[:3, 3] for _, T in pipe.trajectory])
    ate = metrics.ate_rmse(est, gt)
    # the step's detections against make_detector's on the last frame
    last = built[0](torch.from_numpy(np.asarray(frames[-1])).to(pipe.device).to(torch.float32))
    dets = pipe.last_output.detections
    same = all(torch.equal(getattr(last, f), getattr(dets, f))
               for f in ("boxes", "scores", "classes", "valid"))
    matches, filtered, ok, nvalid = (np.array(c) for c in zip(*outs))
    steady = np.array(step_ms[1:])
    share = float(np.median(det_ms[1:]) / np.median(steady))
    success = float(ok[1:].mean())

    def med_p90(ms):
        return float(np.median(ms[1:])), float(np.percentile(ms[1:], 90))

    rec = dict(step_ms=step_ms, detector_span_ms=det_ms, launches=launches, peak_mib=peak_mb,
               ate_m=ate, vo_success=success, num_filtered=filtered.tolist(),
               detections_valid=nvalid.tolist(), detections_equal=same, conf_threshold=DET_CONF,
               step_ms_median_p90=med_p90(step_ms), vo_only_before=med_p90(vo_ms[0]),
               vo_only_after=med_p90(vo_ms[1]), slice_phase=med_p90(slice_rec["step_ms"]),
               vo_only_step_ms=vo_ms, detector_share=share)
    log("detect", f"(b) create_gpu with detection and filtering (the slice's VO-only "
                  f"configuration, YOLO-s random weights, conf_threshold {DET_CONF} so that they "
                  f"fire rarely): {len(frames)} frames, step ms median / p90 "
                  "%.2f / %.2f against the same configuration without the detector just before "
                  "%.2f / %.2f and just after %.2f / %.2f (the slice phase's %.2f / %.2f); "
                  % (*rec["step_ms_median_p90"], *rec["vo_only_before"], *rec["vo_only_after"],
                     *rec["slice_phase"])
                  + f"the detector's span on the stream median "
                  f"{np.median(det_ms[1:]):.2f} ms ({100 * share:.1f} % of a step); "
                  f"num_filtered a frame {filtered.tolist()}; valid detections a frame "
                  f"{nvalid.tolist()}; vo_success {success:.3f}; Sim3 ATE {ate:.4f} m; peak "
                  f"{peak_mb:.1f} MiB; launches {launches}; the last step's detections equal "
                  f"make_detector's on that frame: {same}")
    n = len(frames)
    want = {"corner_rank_maps": n, "extract_patches_levels": n, "match_top2_batched": n}
    if launches != want:
        raise AssertionError(f"detect online launch counts {launches}, expected {want}")
    if not (success >= 0.9 and np.isfinite(est).all() and ate < 0.35 and same):
        raise AssertionError(f"detect online: {rec}")
    return launches, rec


def run_detect_moving(cam, tmp):
    """Parts (c) and (d) on the port's moving-object scene (generate with
    moving_object=True, MOVING_FRAMES frames at 752x480, 10 fps). (c)
    euroc_eval.run(chunk=0) on the first MOVING_ONLINE_FRAMES with
    PipelineConfig()'s features, filtering on and a detector injected
    through the factory's detector= argument that returns the frame's
    ground-truth panel box (boxes.csv) as a person; then detection and
    filtering off. (d) euroc_eval.run(chunk=32) in the eval phase's vio
    configuration with YOLO-s random weights in the front end (B = 33, no
    NMS, gate DET_CONF) and without; counts set to 0 before each run."""
    import dataclasses

    from aria_slam_tpu_torch.config import DetectorConfig, PipelineConfig
    from aria_slam_tpu_torch.core.types import Detections
    from aria_slam_tpu_torch.eval import euroc_eval
    from aria_slam_tpu_torch.io import synthetic_scene
    from aria_slam_tpu_torch.ops.cuda import corner_kernel, match_kernel, patch_kernel
    from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline

    kernels = (corner_kernel.corner_rank_maps, patch_kernel.extract_patches_levels,
               match_kernel.match_top2_batched)
    scene = f"{tmp}/moving"
    t0 = time.perf_counter()
    synthetic_scene.generate(scene, num_frames=MOVING_FRAMES, fps=FPS, cam=cam, depth=4.0,
                             moving_object=True)
    gen_s = time.perf_counter() - t0
    t0_ns = 1_400_000_000_000_000_000
    boxes = {}
    for line in open(f"{scene}/mav0/cam0/boxes.csv").read().splitlines()[1:]:
        f = line.split(",")
        boxes[round((int(f[0]) - t0_ns) / 1e9 * FPS)] = np.array(f[1:], np.float32)
    n_on = MOVING_ONLINE_FRAMES
    in_view = [k for k in range(1, n_on) if k in boxes
               and min(boxes[k][2] - boxes[k][0], boxes[k][3] - boxes[k][1]) >= MIN_BOX_PX]
    log("detect", f"(c) generate(moving_object=True): {MOVING_FRAMES} frames "
                  f"{cam.width}x{cam.height} in {gen_s:.1f} s; the panel's box in "
                  f"{len(boxes)} frames, {len(in_view)} of the first {n_on} at least "
                  f"{MIN_BOX_PX} px a side")
    calls = []

    def gt_detector(image):
        k = len(calls)
        calls.append(k)
        if k in boxes:
            return Detections(torch.from_numpy(boxes[k][None]).to(image.device),
                              torch.ones(1, device=image.device),
                              torch.zeros(1, dtype=torch.int32, device=image.device),
                              torch.ones(1, dtype=torch.bool, device=image.device))
        return Detections(torch.zeros((1, 4), device=image.device),
                          torch.zeros(1, device=image.device),
                          torch.zeros(1, dtype=torch.int32, device=image.device),
                          torch.zeros(1, dtype=torch.bool, device=image.device))

    per_frame = []
    process_frame = SlamPipeline.process_frame

    def recorded(self, *a):
        pose = process_frame(self, *a)
        o = self.last_output
        per_frame.append((int(o.num_filtered), bool(o.vo_success)))
        return pose

    rec = {"generate_s": gen_s, "frames_in_view": in_view}
    for name, cfg, det in (
            ("filtered", PipelineConfig(enable_detection=True, enable_dynamic_filtering=True),
             gt_detector),
            ("unfiltered", PipelineConfig(), None)):
        per_frame.clear()
        t0 = time.perf_counter()
        with mock.patch.object(SlamPipeline, "process_frame", recorded):
            res = euroc_eval.run(scene, out_dir=f"{tmp}/moving_{name}", config=cfg,
                                 max_frames=n_on, verbose=False, chunk=0, detector=det,
                                 keep_pipe=True)
        wall_s = time.perf_counter() - t0
        pipe = res.pop("_pipe")
        est = np.stack([T[:3, 3] for _, T in pipe.trajectory])
        filt = np.array([f for f, _ in per_frame])
        ok = float(np.mean([s for _, s in per_frame[1:]]))
        rec[name] = dict(res, wall_s=wall_s, vo_success=ok, num_filtered=filt.tolist())
        log("detect", f"(c) euroc_eval.run chunk=0, {name}: {res['frames']} frames in "
                      f"{wall_s:.1f} s; num_filtered a frame mean {filt.mean():.1f} (min over "
                      f"the in-view frames {filt[in_view].min() if name == 'filtered' else 0}); "
                      f"vo_success {ok:.3f}; Umeyama scale {res['umeyama_scale']:.4f}; ATE "
                      f"Sim3 {res['ate_rmse_m']:.4f} m, scale-fixed "
                      f"{res['ate_noscale_rmse_m']:.4f} m; steady_frame_ms "
                      f"{res['steady_frame_ms']:.2f}")
        if not np.isfinite(est).all():
            raise AssertionError(f"moving object, {name}: a non-finite pose")
        if name == "filtered" and not (ok >= 0.9 and len(calls) == n_on
                                       and (filt[in_view] > 0).all()):
            raise AssertionError(f"moving object, filtered: vo_success {ok}, detector calls "
                                 f"{len(calls)}, in-view frames without a filtered match "
                                 f"{[k for k in in_view if filt[k] == 0]}")

    # (d) chunk mode, the front end with and without the detector
    det_cfg = dataclasses.replace(DetectorConfig(), conf_threshold=DET_CONF)
    vio = benchmark_config(cam, loop_closure=False)
    launches = {}
    for name, cfg in (("chunk_detect", dataclasses.replace(
            vio, enable_detection=True, enable_dynamic_filtering=True, detector=det_cfg)),
                      ("chunk_plain", vio)):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        for k in kernels:
            k.launches = 0
        t0 = time.perf_counter()
        res = euroc_eval.run(scene, out_dir=f"{tmp}/moving_{name}", config=cfg, verbose=False,
                             chunk=CHUNK, keep_pipe=True)
        wall_s = time.perf_counter() - t0
        launches[name] = {k.__name__: k.launches for k in kernels}
        peak_mb = torch.cuda.max_memory_allocated() / 2**20
        pipe = res.pop("_pipe")
        est = np.stack([T[:3, 3] for _, T in pipe.trajectory])
        rec[name] = dict(res, wall_s=wall_s, peak_mib=peak_mb, launches=launches[name])
        log("detect", f"(d) euroc_eval.run chunk={CHUNK}, vio, "
                      f"{'YOLO-s in the front end (B = 33, no NMS)' if name == 'chunk_detect' else 'no detector'}: "
                      f"{res['frames']} frames in {wall_s:.1f} s; device_chunk "
                      f"{res['stage_ms']['device_chunk']:.1f} ms, frontend "
                      f"{res['stage_ms']['frontend']:.1f} ms a chunk; ATE Sim3 "
                      f"{res['ate_rmse_m']:.4f} m; peak {peak_mb:.1f} MiB; launches "
                      f"{launches[name]}")
        want = {"corner_rank_maps": LOOP_CHUNKS, "extract_patches_levels": LOOP_CHUNKS,
                "match_top2_batched": 2 * LOOP_CHUNKS}
        if launches[name] != want:
            raise AssertionError(f"{name} launch counts {launches[name]}, expected {want}")
        if not np.isfinite(est).all():
            raise AssertionError(f"{name}: a non-finite pose")
    return launches["chunk_detect"], rec


# ------------------------------------------------------ multi, db, aux
MULTI_S = 4              # sequences in one batched front end
MULTI_FRAMES = 65        # a sequence: 4 chunk rounds of 16
MULTI_CHUNK = 16
MULTI_PERIODS = (10.0, 12.0, 14.0, 16.0)
DB_KEYFRAMES = 512       # the keyframe DB of benchmark_config(full_res=True)
DB_FEATURES = 2000
DB_TOP_K = 5
PIN_FRAMES = 60
STRESS_FRAMES = 33
GENERATE_PROCESSES = 6


def generate_scenes(cam, tmp):
    """Every scene of phases 10 to 12, written by the port's generate() in
    parallel child processes: the four sweeps of the multi phase (each its
    own period and seed), the pin probe's rotloop and the photometric
    stress scene. Returns their directories."""
    import concurrent.futures
    import multiprocessing

    from aria_slam_tpu_torch.io import synthetic_scene

    jobs = {f"seq{i}": dict(num_frames=MULTI_FRAMES, fps=FPS, cam=cam, depth=4.0, traj="sweep",
                            period=period, seed=i)
            for i, period in enumerate(MULTI_PERIODS)}
    jobs["pin"] = dict(num_frames=PIN_FRAMES, fps=10.0, cam=cam, depth=4.0, traj="rotloop",
                       period=20.0)
    jobs["stress"] = dict(num_frames=STRESS_FRAMES, fps=10.0, cam=cam, depth=4.0, traj="sweep",
                          period=10.0, noise_std=6.0, exposure_drift=0.3, motion_blur=3)
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with concurrent.futures.ProcessPoolExecutor(GENERATE_PROCESSES, mp_context=ctx) as pool:
        futs = {name: pool.submit(synthetic_scene.generate, f"{tmp}/{name}", **kw)
                for name, kw in jobs.items()}
        dirs = {name: f.result() for name, f in futs.items()}
    log("multi", f"generate(): {len(jobs)} scenes ({MULTI_S} x {MULTI_FRAMES} sweep frames, "
                 f"{PIN_FRAMES} rotloop, {STRESS_FRAMES} stressed) at {cam.width}x{cam.height} "
                 f"in {time.perf_counter() - t0:.1f} s on {GENERATE_PROCESSES} processes")
    return dirs


def multi_records(frames, cfg, dev):
    """The three kernels at the multi phase's shapes, each against its
    plain version on the card: corner and patch at B = S * (C+1) = 68
    frames (one extract of a chunk round), match at the round's N = S * C
    = 64 consecutive pairs of those frames' features."""
    from aria_slam_tpu_torch.ops import brief, orb
    from aria_slam_tpu_torch.ops.cuda import corner_kernel as ck
    from aria_slam_tpu_torch.ops.cuda import match_kernel as mk
    from aria_slam_tpu_torch.ops.cuda import patch_kernel as pk

    s, cp1 = frames.shape[:2]
    flat = list(frames.reshape(s * cp1, *frames.shape[2:]))
    b = len(flat)
    thr, hb, radius = cfg.fast_threshold, cfg.harris_block_size, brief.PATCH_R
    recs = []
    # corner: bit-equal on every level
    levels = pyramid_levels(flat, cfg, dev)
    got = ck.corner_rank_maps(levels, thr, hb)
    for lvl, g in zip(levels, got):
        if not torch.equal(g, ck.corner_rank_map_plain(lvl, thr, hb)):
            raise AssertionError(f"corner B={b} {tuple(lvl.shape)}: not bit-equal")
    px = sum(lvl.numel() for lvl in levels)
    b_ms, by = bound(2 * 4 * px, corner_ops(levels, got, thr, hb // 2), F32_OPS_PER_MS)
    del got
    recs.append(dict(name=f"corner_rank_map B={b} (multi)", path="multi", route="cuda",
                     source="aria_slam_tpu_torch/csrc/corner_kernel.cu",
                     replaces="aria_slam_tpu/ops/pallas/corner_kernel.py:125",
                     wrapper="corner_rank_maps", max_abs_err=0.0, library_ms=None,
                     ms=graph_ms(lambda: ck.corner_rank_maps(levels, thr, hb), iters=5,
                                 replays=4),
                     launch_ms=cuda_ms(lambda: ck.corner_rank_maps(levels, thr, hb), iters=5),
                     plain_ms=graph_ms(lambda: [ck.corner_rank_map_plain(lvl, thr, hb)
                                                for lvl in levels], iters=1, replays=2),
                     bound_ms=b_ms, bound_by=by))
    del levels
    torch.cuda.empty_cache()
    # patch: exact, all levels in one launch
    inputs = level_inputs(flat, cfg, dev)
    blurred = [img for _, img, _ in inputs]
    xys = [xy for _, _, xy in inputs]
    got = pk.extract_patches_levels(blurred, xys, radius)
    if not torch.equal(got, pk.extract_patches_levels_plain(blurred, xys, radius)):
        raise AssertionError(f"patch B={b}: differs from the plain version")
    del got
    indices = [pk.patch_indices(img.shape, xy, radius) for img, xy in zip(blurred, xys)]
    bi = torch.arange(b, device=dev)[:, None, None, None]
    b_ms, by = bound(patch_bytes(blurred, xys, indices), 0.0, F32_OPS_PER_MS)
    reps = dict(iters=3, replays=3)
    recs.append(dict(name=f"extract_patches B={b} (multi)", path="multi", route="cuda",
                     source="aria_slam_tpu_torch/csrc/patch_kernel.cu",
                     replaces="aria_slam_tpu/ops/pallas/patch_kernel.py:60",
                     wrapper="extract_patches_levels", max_abs_err=0.0,
                     ms=graph_ms(lambda: pk.extract_patches_levels(blurred, xys, radius), **reps),
                     launch_ms=cuda_ms(lambda: pk.extract_patches_levels(blurred, xys, radius),
                                       iters=5),
                     plain_ms=graph_ms(lambda: pk.extract_patches_levels_plain(blurred, xys,
                                                                               radius), **reps),
                     library_ms=graph_ms(lambda: [img[bi, yy, xx] for img, (yy, xx)
                                                  in zip(blurred, indices)], **reps),
                     bound_ms=b_ms, bound_by=by))
    del inputs, blurred, xys, indices
    torch.cuda.empty_cache()
    # match: the round's consecutive pairs, (q, i) -> (q, i + 1)
    feats = orb.extract_batch(torch.from_numpy(np.stack(flat)).to(dev).float(), cfg)
    desc = feats.desc.reshape(s, cp1, *feats.desc.shape[1:])
    valid = feats.valid.reshape(s, cp1, -1)
    q = desc[:, 1:].reshape(s * (cp1 - 1), *desc.shape[2:]).contiguous()
    t = desc[:, :-1].reshape(s * (cp1 - 1), *desc.shape[2:]).contiguous()
    v = valid[:, :-1].reshape(s * (cp1 - 1), -1).contiguous()
    del feats
    err = max(int((g.long() - w.long()).abs().max())
              for g, w in zip(mk.match_top2_batched(q, t, v), mk.match_top2_plain(q, t, v)))
    torch.cuda.empty_cache()
    if err:
        raise AssertionError(f"match N={q.shape[0]} (multi): max abs error {err}")
    b_ms, by = match_bound(q, t, v)
    recs.append(dict(name=f"match_top2 N={q.shape[0]} (multi)", path="multi", **MATCH_COMMON,
                     max_abs_err=float(err),
                     ms=graph_ms(lambda: mk.match_top2_batched(q, t, v), iters=5, replays=4),
                     launch_ms=cuda_ms(lambda: mk.match_top2_batched(q, t, v), iters=10),
                     plain_ms=graph_ms(lambda: mk.match_top2_plain(q, t, v), iters=1, replays=2),
                     bound_ms=b_ms, bound_by=by))
    torch.cuda.empty_cache()
    log("multi", "kernels at the round's shapes, each equal to its plain version: "
        + "; ".join(f"{r['name']} {r['ms']:.4f} ms (bound {r['bound_ms']:.5f} ms, "
                    f"{r['bound_by']}; with launch cost {r['launch_ms']:.4f} ms; plain "
                    f"{r['plain_ms']:.4f} ms"
                    + (f"; indexing gathers {r['library_ms']:.4f} ms" if r.get("library_ms")
                       else "") + ")" for r in recs))
    return recs


def run_multi(dirs, mesh):
    """Phase 10: multi_eval.run_scenes over the four sweeps at chunk 16 as
    ONE batched program a round (S = 4) on the one-card mesh, the counts
    set to 0 just before it and read just after; then the same sequences
    one at a time (S = 1), back to back. Gates: each sequence's poses
    equal at S = 4 and alone, every ATE finite and < 0.35 m. Then the
    kernels at the round's shapes."""
    from aria_slam_tpu_torch.config import OrbConfig, PipelineConfig
    from aria_slam_tpu_torch.eval import multi_eval
    from aria_slam_tpu_torch.io import euroc
    from aria_slam_tpu_torch.ops.cuda import corner_kernel, match_kernel, patch_kernel
    from aria_slam_tpu_torch.utils.profiling import StageTimer

    kernels = (corner_kernel.corner_rank_maps, patch_kernel.extract_patches_levels,
               match_kernel.match_top2_batched)
    seqs = [dirs[f"seq{i}"] for i in range(MULTI_S)]
    cfg = PipelineConfig(enable_loop_closure=False, enable_mapping=False, enable_fusion=False,
                         enable_detection=False)
    rounds = -(-(MULTI_FRAMES - 1) // MULTI_CHUNK)

    def one(batch, sampler=None):
        timer = StageTimer(device=mesh.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = multi_eval.run_scenes(batch, cfg, chunk=MULTI_CHUNK, mesh=mesh, verbose=False,
                                    timer=timer, keep_trajectories=True, sampler=sampler)
        torch.cuda.synchronize()
        return res, (time.perf_counter() - t0) * 1e3, timer.summary()

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for k in kernels:
        k.launches = 0
    res4, ms4, stages4 = one(seqs)
    launches = {k.__name__: k.launches for k in kernels}
    peak = torch.cuda.max_memory_allocated() / 2**20
    # each sequence alone draws from the generator it had in the batch
    singles = [one([d], multi_eval.SequenceSampler([torch.Generator(device=mesh.device)
                                                    .manual_seed(multi_eval.sequence_seed(0, q))]))
               for q, d in enumerate(seqs)]
    ms1 = sum(m for _, m, _ in singles)
    seq_frames = MULTI_S * MULTI_FRAMES
    ates4 = [r["ate_rmse_m"] for r in res4]
    ates1 = [r[0]["ate_rmse_m"] for r, _, _ in singles]
    traj_diff = max(float(np.abs(r4["trajectory"] - r1[0]["trajectory"]).max())
                    for r4, (r1, _, _) in zip(res4, singles))
    front1 = [st["frontend"]["mean_ms"] for _, _, st in singles]

    def split(ms, st):
        """(steady ms a round, first round ms, start-up and scoring ms):
        the rounds after the first, the first, and the rest of the run."""
        r = st["round"]
        return r["mean_ms"], r["warm_ms"], ms - r["warm_ms"] - r["total_ms"]

    steady4, first4, start4 = split(ms4, stages4)
    parts1 = [split(m, st) for _, m, st in singles]
    steady1 = sum(p[0] for p in parts1)  # one steady round of each sequence
    pair_frames = MULTI_S * MULTI_CHUNK  # sequence-frames a round of all four
    log("multi", f"run_scenes S={MULTI_S} x {MULTI_FRAMES} frames at chunk {MULTI_CHUNK} "
                 f"({rounds} rounds, {mesh.shape} NCCL mesh). Steady rounds (after the "
                 f"first): S={MULTI_S} {steady4:.1f} ms a round, "
                 f"{1e3 * pair_frames / steady4:.2f} sequence-frames a second; S=1 "
                 f"{', '.join(f'{p[0]:.1f}' for p in parts1)} ms a round, "
                 f"{1e3 * pair_frames / steady1:.2f} sequence-frames a second one after "
                 f"another; S={MULTI_S} / S=1 steady throughput {steady1 / steady4:.3f}x. "
                 f"First round S={MULTI_S} {first4:.1f} ms, S=1 "
                 f"{', '.join(f'{p[1]:.1f}' for p in parts1)} ms; start-up and scoring "
                 f"S={MULTI_S} {start4:.1f} ms, S=1 {', '.join(f'{p[2]:.1f}' for p in parts1)} "
                 f"ms. Whole runs (start-up included): S={MULTI_S} {ms4:.1f} ms, "
                 f"{1e3 * seq_frames / ms4:.2f} sequence-frames a second; S=1 {ms1:.1f} ms in "
                 f"all, {1e3 * seq_frames / ms1:.2f}; {ms1 / ms4:.3f}x. Stages S={MULTI_S}, "
                 f"steady mean ms a round (first): "
                 + "; ".join(f"{n} {v['mean_ms']:.1f} ({v['warm_ms']:.1f})"
                             for n, v in sorted(stages4.items()))
                 + f"; S=1 frontend {', '.join(f'{m:.1f}' for m in front1)} ms a round; Sim3 "
                   f"ATE S={MULTI_S} " + ", ".join(f"{a:.4f}" for a in ates4) + " m, S=1 "
                 + ", ".join(f"{a:.4f}" for a in ates1)
                 + f" m (poses differ by {traj_diff:.3g} at most); launches {launches} "
                   f"({ {k: v / rounds for k, v in launches.items()} } a round); peak "
                   f"{peak:.1f} MiB")
    want = {"corner_rank_maps": rounds, "extract_patches_levels": rounds,
            "match_top2_batched": rounds}
    if launches != want:
        raise AssertionError(f"multi launch counts {launches}, expected {want}")
    if traj_diff != 0.0:
        raise AssertionError(f"multi: a sequence's poses at S={MULTI_S} and alone differ by "
                             f"{traj_diff} (the same generators must give the same poses)")
    for r in res4 + [r[0] for r, _, _ in singles]:
        if r["frames"] != MULTI_FRAMES or not np.isfinite(r["trajectory"]).all():
            raise AssertionError(f"multi: {r['sequence']} has {r['frames']} poses or a "
                                 "non-finite pose")
        if not r["ate_rmse_m"] < 0.35:
            raise AssertionError(f"multi: {r['sequence']} Sim3 ATE {r['ate_rmse_m']} m "
                                 "(limit 0.35 m)")
    frames = np.stack([np.stack([euroc.load_image(p) for p in euroc.load(d).image_paths[
        :MULTI_CHUNK + 1]]) for d in seqs])
    recs = multi_records(frames, OrbConfig(), mesh.device)
    rec = dict(steady_round_ms=steady4, steady_round_ms_s1=[p[0] for p in parts1],
               steady_seq_frames_per_s=1e3 * pair_frames / steady4,
               steady_seq_frames_per_s_s1=1e3 * pair_frames / steady1,
               first_round_ms=first4, first_round_ms_s1=[p[1] for p in parts1],
               startup_ms=start4, startup_ms_s1=[p[2] for p in parts1],
               ms=ms4, stages=stages4, ms_s1=ms1,
               frontend_ms_s1=front1, seq_frames_per_s=1e3 * seq_frames / ms4,
               seq_frames_per_s_s1=1e3 * seq_frames / ms1, ate_m=ates4, ate_m_s1=ates1,
               pose_diff_s4_s1=traj_diff, peak_mib=peak,
               launches_a_round={k: v / rounds for k, v in launches.items()})
    return launches, rec, recs


def run_db(mesh):
    """Phase 11: a 512-keyframe DB at F = 2000 with two planted revisits
    (tests/test_sharded_db.py's construction at full size) queried with
    sharded_topk_scores on the one-card mesh, the counts set to 0 just
    before it; against match_scores_vs_database and the plain route on
    the card. Gates: the same top-5 with equal scores slot for slot, the
    planted revisits among them. Then the match kernel at N = 512 against
    its plain version."""
    from aria_slam_tpu_torch.ops import match as match_ops
    from aria_slam_tpu_torch.ops.cuda import match_kernel as mk
    from aria_slam_tpu_torch.ops.topk import top_k_stable
    from aria_slam_tpu_torch.parallel.sharded_db import sharded_topk_scores

    dev, n, f = mesh.device, DB_KEYFRAMES, DB_FEATURES
    g = torch.Generator(device=dev).manual_seed(11)
    db = torch.randint(0, 2, (n, f, 256), generator=g, device=dev, dtype=torch.int8)
    dbv = torch.rand((n, f), generator=g, device=dev) < 0.9
    q = torch.randint(0, 2, (f, 256), generator=g, device=dev, dtype=torch.int8)
    qv = torch.rand((f,), generator=g, device=dev) < 0.9
    hits = (n // 6, n // 2 + 5)
    for hit, share in zip(hits, (0.8, 0.6)):  # of the query's descriptors, as the test's
        share = int(share * f)
        db[hit, :share] = q[:share]
        dbv[hit, :share] = True
    torch.cuda.synchronize()
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated() / 2**20
    mk.match_top2_batched.launches = 0
    t0 = time.perf_counter()
    vals, idx = sharded_topk_scores(mesh, q, qv, db, dbv, 0.7, DB_TOP_K)
    torch.cuda.synchronize()
    query_ms = (time.perf_counter() - t0) * 1e3
    launches = {"match_top2_batched": mk.match_top2_batched.launches}
    peak = torch.cuda.max_memory_allocated() / 2**20
    scores = match_ops.match_scores_vs_database(q, qv, db, dbv, 0.7)
    rep = q.expand(n, f, 256).contiguous()
    # the kernel at N = 512 against the plain route in two halves of 256
    # keyframes (its temporaries hold about 20 GB a half): best, second and
    # best index equal element by element
    kern = mk.match_top2_batched(rep, db, dbv)
    plain, err = [], 0
    for lo in (0, n // 2):
        half = mk.match_top2_plain(rep[lo:lo + n // 2], db[lo:lo + n // 2], dbv[lo:lo + n // 2])
        err = max([err] + [int((k[lo:lo + n // 2].long() - w.long()).abs().max())
                           for k, w in zip(kern, half)])
        best, second, _ = half
        plain.append(match_ops.ratio_gate(qv[None], best, second, 0.7).float().sum(1)
                     / torch.clamp(qv.float().sum(), min=1.0))
        del half, best, second
        torch.cuda.empty_cache()
    del kern
    if err:
        raise AssertionError(f"match N={n} (db query): max abs error {err} against the plain "
                             "version")
    plain = torch.cat(plain)
    pv, pi = top_k_stable(plain, DB_TOP_K)
    got = [x.cpu().numpy() for x in (vals, idx, scores, pv, pi, plain)]
    vals, idx, scores, pv, pi, plain = got
    log("db", f"sharded_topk_scores on {mesh.shape}: {n} keyframes x {f} features, one query: "
              f"{query_ms:.2f} ms (first call); top-{DB_TOP_K} {idx.tolist()} scores "
              f"{[round(float(x), 4) for x in vals]}; plain route {pi.tolist()}; planted "
              f"{list(hits)}; peak {peak:.1f} MiB ({base:.1f} MiB held before: the DB "
              f"{db.numel() / 2**20:.1f} MiB; the query repeated for every keyframe "
              f"{rep.numel() / 2**20:.1f} MiB); launches {launches}")
    if not (np.array_equal(idx, pi) and np.array_equal(vals, pv)
            and np.array_equal(vals, scores[idx]) and np.array_equal(scores, plain)):
        raise AssertionError("db: the sharded top-k differs from the single-device scores or "
                             "the plain route")
    if not set(hits) <= set(idx.tolist()):
        raise AssertionError(f"db: the planted revisits {hits} are not in the top-k {idx}")
    if launches != {"match_top2_batched": 1}:
        raise AssertionError(f"db launch counts {launches}, expected one match launch")
    torch.cuda.synchronize()
    qms = cuda_ms(lambda: sharded_topk_scores(mesh, q, qv, db, dbv, 0.7, DB_TOP_K), iters=5)
    b_ms, by = match_bound(rep, db, dbv)
    plain_ms = sum(cuda_ms(lambda: mk.match_top2_plain(rep[lo:lo + n // 2], db[lo:lo + n // 2],
                                                       dbv[lo:lo + n // 2]),
                           iters=1, warmup=1, repeats=1) for lo in (0, n // 2))
    torch.cuda.empty_cache()
    rec = dict(name=f"match_top2 N={n} (db query)", path="db", **MATCH_COMMON,
               max_abs_err=float(err),
               ms=graph_ms(lambda: mk.match_top2_batched(rep, db, dbv), iters=3, replays=3),
               launch_ms=cuda_ms(lambda: mk.match_top2_batched(rep, db, dbv), iters=5),
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=by)
    log("db", f"the whole query {qms:.3f} ms a call; match kernel N={n} {rec['ms']:.4f} ms "
              f"(bound {b_ms:.5f} ms, {by}), with launch cost {rec['launch_ms']:.4f} ms, plain "
              f"{plain_ms:.2f} ms (two halves, once)")
    del rep, db, dbv
    torch.cuda.empty_cache()
    return launches, dict(query_ms_first=query_ms, query_ms=qms, peak_mib=peak,
                          held_mib=base, top_k=idx.tolist(), scores=vals.tolist()), rec


def run_aux(dirs, cam, tmp, dev):
    """Phase 12: imu_benchmark.run(10 s) on the card (gate: mean error <
    5 cm, tests/test_components.py's), pin_probe.run(full_res=True,
    frames=60) (gate: every estimator finite), and the photometric stress
    scene (noise 6, exposure drift 0.3, blur 3 px; 33 frames) through
    euroc_eval.run at chunk 16 (gate: Sim3 ATE < 0.5 m,
    tests/test_robustness.py's)."""
    from aria_slam_tpu_torch.config import (
        LoopClosureConfig, MapperConfig, PipelineConfig, PoseGraphConfig,
    )
    from aria_slam_tpu_torch.eval import euroc_eval, imu_benchmark, pin_probe

    rec = {}
    t0 = time.perf_counter()
    imu = imu_benchmark.run(10.0, verbose=False, device=dev)
    rec["imu"] = dict(imu, ms=(time.perf_counter() - t0) * 1e3)
    log("aux", f"imu_benchmark 10 s (2000 IMU samples + 200 visual updates) on the card: mean "
               f"error {imu['mean_err_m'] * 100:.3f} cm, max {imu['max_err_m'] * 100:.3f} cm, "
               f"{rec['imu']['ms']:.0f} ms")
    if not imu["mean_err_m"] < 0.05:
        raise AssertionError(f"imu_benchmark mean error {imu['mean_err_m']} m (limit 0.05 m)")

    t0 = time.perf_counter()
    pin = pin_probe.run(True, PIN_FRAMES, dirs["pin"], verbose=False, device=dev)
    rec["pin"] = dict(pin, ms=(time.perf_counter() - t0) * 1e3)
    log("aux", f"pin_probe full resolution, {pin['pairs']} pairs ({pin['pairs_ok']} ok) in "
               f"{rec['pin']['ms']:.0f} ms; median ratios: "
               + ", ".join(f"{k} {v['median_ratio']}" for k, v in pin["estimators"].items()))
    if not all(np.isfinite(v[s]) for v in pin["estimators"].values()
               for s in ("geomean_ratio", "log_std", "median_ratio")):
        raise AssertionError(f"pin_probe: a non-finite estimator {pin['estimators']}")

    cfg = PipelineConfig(
        camera=cam,
        loop=LoopClosureConfig(max_keyframes=192, min_frames_between=90, min_score=0.3,
                               min_matches=40),
        mapper=MapperConfig(max_points=60000, pair_lag=4),
        pose_graph=PoseGraphConfig(max_nodes=192, max_edges=512, lm_iterations=5,
                                   cg_iterations=32),
        enable_fusion=False)
    t0 = time.perf_counter()
    res = euroc_eval.run(dirs["stress"], out_dir=f"{tmp}/stress_out", config=cfg, verbose=False,
                         chunk=16, device=dev)
    rec["stress"] = dict(ate_m=res["ate_rmse_m"], ms=(time.perf_counter() - t0) * 1e3)
    log("aux", f"photometric stress ({STRESS_FRAMES} frames, noise 6, exposure drift 0.3, blur "
               f"3 px) through euroc_eval.run at chunk 16: Sim3 ATE {res['ate_rmse_m']:.4f} m "
               f"in {rec['stress']['ms']:.0f} ms")
    if not res["ate_rmse_m"] < 0.5:
        raise AssertionError(f"photometric stress Sim3 ATE {res['ate_rmse_m']} m (limit 0.5 m)")
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few steady frame steps (torch.profiler)")
    args = ap.parse_args()
    t_start = time.perf_counter()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 1
    name = torch.cuda.get_device_name(0)
    smi = smi_line()
    log("device", f"{name} | {smi} | torch {torch.__version__} CUDA {torch.version.cuda} | "
                  f"matmul TF32 {torch.backends.cuda.matmul.allow_tf32}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 matmuls are enabled; the port computes in float32")
    dev = torch.device("cuda")

    from aria_slam_tpu_torch.config import CameraConfig, OrbConfig
    from aria_slam_tpu_torch.ops.cuda import _lib

    # 2. build
    _lib.build_all()
    secs, report = _lib.build_report()
    ptxas = ptxas_lines(report)
    log("build", f"3 kernel libraries in {secs:.1f} s; ptxas: " + " | ".join(ptxas))

    # 3. kernels vs plain
    cam = CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0)  # EuRoC intrinsics, no distortion
    t0 = time.perf_counter()
    frames, gt, imu = render_frames(cam, CHUNKED_FRAMES, FPS)
    log("render", f"{CHUNKED_FRAMES} frames {cam.width}x{cam.height} in "
                  f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    orb_cfg = OrbConfig()
    log("kernels", f"device times below on {smi}")
    match_recs, extra = check_match(dev, rng)
    corner_recs, corner_extra = check_corner(frames, orb_cfg, dev)
    extra.update(corner_extra)
    patch_recs, patch_extra = check_patch(frames, orb_cfg, dev, rng)
    extra.update(patch_extra)
    records = corner_recs + patch_recs + match_recs

    # 4. the online slice, 5. the chunked path, 6. loop closure: each with
    # the counts set to 0 just before it and read just after
    launches = {}
    launches["online"], slice_rec = run_slice(frames[:NUM_FRAMES], gt[:NUM_FRAMES], imu, cam)
    launches["chunked"], chunked_rec = run_chunked(frames, gt, imu, cam)
    t0 = time.perf_counter()
    loop_frames, loop_gt, loop_imu = render_frames(cam, LOOP_FRAMES, FPS, "rotloop", LOOP_PERIOD)
    log("render", f"{LOOP_FRAMES} rotloop frames in {time.perf_counter() - t0:.1f} s")
    launches["loop"], loop_rec, verify_args = run_loop(loop_frames, loop_gt, loop_imu, cam)
    records.append(check_verify_match(*(x.to(dev) for x in verify_args)))
    del verify_args
    with tempfile.TemporaryDirectory(prefix="chip_smoke_eval_") as tmp:
        launches["eval"], eval_rec = run_eval(cam, tmp)
        # 8. the online path with every feature on
        launches["online_lc"], online_rec = run_online(cam, tmp, loop_gt,
                                                       eval_rec["variants"]["vio_lc"])
        # 9. the detector: alone, in the online step, on the moving-object
        # scene online and in the chunked front end
        detect_rec = {"alone": run_detect_alone(frames, dev)}
        launches["detect_online"], detect_rec["online"] = run_detect_online(
            frames[:NUM_FRAMES], gt[:NUM_FRAMES], imu, cam, slice_rec)
        launches["detect_chunked"], detect_rec["moving"] = run_detect_moving(cam, tmp)
    # 10. multi, 11. db (both on a one-card NCCL mesh), 12. aux
    from aria_slam_tpu_torch.parallel import mesh as mesh_lib

    with tempfile.TemporaryDirectory(prefix="chip_smoke_multi_") as tmp:
        dirs = generate_scenes(cam, tmp)
        with mesh_lib.single_process_group("nccl"):
            mesh = mesh_lib.make_mesh(1, 1)
            launches["multi"], multi_rec, multi_recs = run_multi(dirs, mesh)
            records += multi_recs
            launches["db"], db_rec, db_kernel = run_db(mesh)
            records.append(db_kernel)
        aux_rec = run_aux(dirs, cam, tmp, dev)
    # the kernels at their shapes on the detection paths: the same device
    # times, the launches of those runs
    for r in list(records):
        det_path = {"online": "detect_online", "chunked": "detect_chunked"}.get(r["path"])
        if det_path and "role" not in r:
            records.append(dict(r, name=f"{r['name']} (detection on)", path=det_path))
    by_role = {"loop": loop_rec["match_launches"], "online_lc": online_rec["match_launches"]}
    for r in records:
        r["launches"] = (by_role[r["path"]][r["role"]] if "role" in r
                         else launches[r["path"]][r["wrapper"]])
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']} was not launched on the {r['path']} path")
    if args.profile:
        extra["profile"] = profile_slice(frames, imu, cam)
        extra["profile_chunked"] = profile_chunked(frames, imu, chunked_config(cam), NUM_CHUNKS,
                                                   "chunked")
        extra["profile_loop"] = profile_chunked(loop_frames, loop_imu, benchmark_config(cam),
                                                LOOP_CHUNKS, "loop")

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": name, "nvidia_smi": smi, "kernels": records,
                       "slice": slice_rec, "chunked": chunked_rec, "loop": loop_rec,
                       "eval": eval_rec, "online": online_rec, "detect": detect_rec,
                       "multi": multi_rec, "db": db_rec, "aux": aux_rec,
                       "build_s": secs, "ptxas": ptxas, "seconds": time.perf_counter() - t_start,
                       **extra}, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    log("done", f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
