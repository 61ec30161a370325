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
              N = 32 and 29 pairs): the corner maps bit-equal at B = 1, 3
              and 33, the match results bit-exact on eleven cases up to
              N = 256 pairs of 2000x2000, the patches of all 8 levels
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
              also at N = 4, 32 (a chunk's consecutive pairs) and 256.
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

The line before the last holds the card's name and power limit as
nvidia-smi reports them, the one before it the kernels' JSON record (each
kernel at the online slice's shape with that slice's launches, and at the
chunked path's shape with that path's), and the last line is
{"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time

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


def render_frames(cam, n: int, fps: float):
    """n frames of the multi-depth synthetic scene along the sweep
    trajectory, their ground-truth positions, and the 200 Hz IMU stream."""
    from aria_slam_tpu_torch.io import synthetic_scene as ss

    layers = ss.scene_layers(4.0, 0)
    frames, gt = [], []
    for k in range(n):
        pos, R = ss.trajectory(k / fps)
        frames.append(ss.render_frame(cam, None, pos, R, layers=layers))
        gt.append(pos)
    return frames, np.stack(gt), ss.imu_samples(n / fps)


# --------------------------------------------------------------- kernels
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
    for name in ("N1", "N4", "N32", "N256"):
        q, t, v = cases[name]
        n, kq, kt = q.shape[0], q.shape[1], t.shape[1]
        slices, _ = mk.split_plan(n, kq, kt, sms)
        plans[name] = dict(slices=slices, blocks=n * -(-kq // mk._QUERY_BLOCK) * slices)
        big = n > 16
        ms = graph_ms(lambda: mk.match_top2_batched(q, t, v),
                      iters=5 if big else 20, replays=4 if big else 10)
        b_ms, by = bound(q.numel() + t.numel() + v.numel() + 3 * 4 * n * kq,
                         2.0 * n * kq * kt * 256, INT8_OPS_PER_MS)
        rows[name] = dict(ms=ms, bound_ms=b_ms, bound_by=by)
    q, t, v = cases["N1"]
    launch_ms = cuda_ms(lambda: mk.match_top2_batched(q, t, v), iters=50)
    plain_ms = graph_ms(lambda: mk.match_top2_plain(q, t, v))
    q32, t32, v32 = cases["N32"]
    rows["N32"]["launch_ms"] = cuda_ms(lambda: mk.match_top2_batched(q32, t32, v32), iters=10)
    rows["N32"]["plain_ms"] = graph_ms(lambda: mk.match_top2_plain(q32, t32, v32),
                                       iters=2, replays=3)
    log("kernels", f"match: bit-exact on {len(cases)} cases; plain N=1 {plain_ms:.4f} ms, "
                   f"N=32 {rows['N32']['plain_ms']:.4f} ms; "
                   + "; ".join(f"{k} 2000x2000 kernel {r['ms']:.4f} ms (bound {r['bound_ms']:.5f} "
                               f"ms, {r['bound_by']}; {plans[k]['slices']} slices, "
                               f"{plans[k]['blocks']} blocks)" for k, r in rows.items())
                   + f"; with launch cost N1 {launch_ms:.4f} ms, N32 "
                     f"{rows['N32']['launch_ms']:.4f} ms")
    rows["N1"].update(plain_ms=plain_ms, launch_ms=launch_ms)
    common = dict(route="cuda", source="aria_slam_tpu_torch/csrc/match_kernel.cu",
                  replaces="aria_slam_tpu/ops/pallas/match_kernel.py:56", max_abs_err=0.0,
                  library_ms=None, wrapper="match_top2_batched")
    keys = ("ms", "plain_ms", "bound_ms", "bound_by", "launch_ms")
    return [dict(name="match_top2 N=1", path="online", **common,
                 **{k: rows["N1"][k] for k in keys}),
            dict(name="match_top2 N=32", path="chunked", **common,
                 **{k: rows["N32"][k] for k in keys})], {"match": rows, "match_plans": plans}


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
    imu_t, imu_a, imu_g = imu
    gc.collect()  # drop the kernel phase's graphs and tensors before measuring memory
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    base_mb = torch.cuda.memory_allocated() / 2**20
    for k in kernels:
        k.launches = 0
    step_ms, outs, t_prev = [], [], -np.inf
    for k, img in enumerate(frames):
        ts = k / FPS
        for j in np.nonzero((imu_t > t_prev) & (imu_t <= ts))[0]:  # (t_prev, ts]
            pipe.process_imu(imu_t[j], imu_a[j], imu_g[j])
        t0 = time.perf_counter()
        pipe.process_frame(img, ts)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        o = pipe.last_output
        outs.append((int(o.num_features), int(o.num_matches), int(o.num_inliers),
                     bool(o.vo_success)))
        t_prev = ts
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


def profile_chunked(frames, imu, cam):
    """One steady chunk (the third) under torch.profiler: wall ms, the
    card's busy ms, device kernels and copies, cudaLaunchKernel calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from aria_slam_tpu_torch.eval.chunked import ChunkedSlam

    stack, ts, gyro_R, gyro_ok = chunked_inputs(frames, imu)
    slam = ChunkedSlam(chunked_config(cam), chunk=CHUNK, seed=0)
    for k in range(NUM_CHUNKS - 1):
        feed_chunk(slam, k, stack, ts, gyro_R, gyro_ok, imu)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        feed_chunk(slam, NUM_CHUNKS - 1, stack, ts, gyro_R, gyro_ok, imu)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
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
               top_device_ms=[(e.key, e.self_device_time_total / 1e3, e.count) for e in top_dev],
               top_host_ms=[(e.key, e.self_cpu_time_total / 1e3, e.count) for e in top_host])
    log("profile", f"chunked, one steady chunk of {CHUNK}: wall {wall_ms:.1f} ms "
                   f"({wall_ms / CHUNK:.2f} ms a frame), device busy {busy_ms:.2f} ms "
                   f"({100 * busy_ms / wall_ms:.2f} %), {len(dev)} device kernels+copies, "
                   f"{n_launch} cudaLaunchKernel calls ({launch_host_ms:.1f} ms of host time); "
                   "top device ops "
                   + ", ".join(f"{k} {ms:.2f} ms x{c}" for k, ms, c in rec["top_device_ms"][:6]))
    return rec


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write every measurement to this JSON file")
    ap.add_argument("--profile", action="store_true",
                    help="also profile a few steady frame steps (torch.profiler)")
    args = ap.parse_args()

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

    # 4. the online slice, 5. the chunked path: each with the counts set to
    # 0 just before it and read just after
    launches = {}
    launches["online"], slice_rec = run_slice(frames[:NUM_FRAMES], gt[:NUM_FRAMES], imu, cam)
    launches["chunked"], chunked_rec = run_chunked(frames, gt, imu, cam)
    for r in records:
        r["launches"] = launches[r["path"]][r["wrapper"]]
        if r["launches"] < 1:
            raise AssertionError(f"{r['name']} was not launched on the {r['path']} path")
    if args.profile:
        extra["profile"] = profile_slice(frames, imu, cam)
        extra["profile_chunked"] = profile_chunked(frames, imu, cam)

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": name, "nvidia_smi": smi, "kernels": records,
                       "slice": slice_rec, "chunked": chunked_rec, "build_s": secs,
                       "ptxas": ptxas, **extra}, f, indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
