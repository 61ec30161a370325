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
              2000 features), with the device times (CUDA graph replay,
              launch cost excluded) of the kernel, the plain version and,
              where one exists, a single PyTorch call computing the same
              function (timed here, never used by the port), beside the
              least time the card could take and the kernel's time with
              its launch cost.
4. slice   -- 40 rendered frames through the port's own entry points
              (factory.create_gpu, SlamPipeline.process_imu /
              process_frame / finalize) in the VO-only configuration at
              full EuRoC width; checks the kernels' launch counts, the VO
              success share and the Sim3 ATE against the rendered ground
              truth.

The line before the last holds the card's name and power limit as
nvidia-smi reports them, the one before it the kernels' JSON record, and
the last line is {"ok": true, "device": {...}}.
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

# float32 operations per output pixel of the corner rank map: FAST-9 (16
# ring differences, 16 negations, 16 arcs x 16 minima, 2 x 15 arc maxima,
# 3 for the score), 3x3 NMS (9 maxima, 2 compares), Sobel (2 x 7), the
# three gradient products, separable 7x7 box sums of three maps (3 x 12),
# Harris (7) and the final select (1)
CORNER_OPS_PER_PX = 16 + 16 + 256 + 30 + 3 + 11 + 14 + 3 + 36 + 7 + 1

NUM_FRAMES = 40
FPS = 10.0


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 30, warmup: int = 3) -> float:
    """Mean time of fn() in ms, from CUDA events around `iters`
    back-to-back calls after `warmup` calls. Where a call's device work is
    shorter than its host cost (allocation, checks, the launch), this
    measures the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


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

    cases = {"N1": case(1, 2000, 2000), "N4": case(4, 2000, 2000),
             "ragged": case(2, 300, 777), "dups": case(1, 500, 600, dup=True),
             "all_invalid": case(1, 70, 130, all_invalid=True), "kt1": case(3, 65, 1, 0.0)}
    for name, args in cases.items():
        got = mk.match_top2_batched(*args)
        want = mk.match_top2_plain(*args)
        torch.cuda.synchronize()
        for g, w, what in zip(got, want, ("best", "second", "best_idx")):
            if not torch.equal(g, w):
                raise AssertionError(f"match {name}: {what} differs from the plain version "
                                     f"at {int((g != w).sum())} queries")
    q, t, v = cases["N1"]
    ms = graph_ms(lambda: mk.match_top2_batched(q, t, v))
    launch_ms = cuda_ms(lambda: mk.match_top2_batched(q, t, v), iters=50)
    plain_ms = graph_ms(lambda: mk.match_top2_plain(q, t, v))
    n4_ms = graph_ms(lambda: mk.match_top2_batched(*cases["N4"]))
    kq, kt = q.shape[1], t.shape[1]
    bound_ms, by = bound(q.numel() + t.numel() + v.numel() + 3 * 4 * kq,
                         2.0 * kq * kt * 256, INT8_OPS_PER_MS)
    log("kernels", f"match: bit-exact on {len(cases)} cases; N=1 2000x2000 "
                   f"kernel {ms:.4f} ms ({launch_ms:.4f} ms with launch cost), plain "
                   f"{plain_ms:.4f} ms, N=4 kernel {n4_ms:.4f} ms, bound {bound_ms:.5f} ms ({by})")
    return dict(name="match_top2", route="cuda",
                source="aria_slam_tpu_torch/csrc/match_kernel.cu",
                replaces="aria_slam_tpu/ops/pallas/match_kernel.py:56",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=None, launch_ms=launch_ms), {"match_n4_ms": n4_ms}


def level_inputs(frames, cfg, dev):
    """Per pyramid level: the (B, H, W) level images, their 5x5-blurred
    copies and the level's keypoints from the ORB detector, B frames."""
    from aria_slam_tpu_torch.ops import brief, orb
    from aria_slam_tpu_torch.ops.pyramid import build_pyramid

    imgs = torch.from_numpy(np.stack(frames).astype(np.float32)).to(dev)
    levels = build_pyramid(imgs, cfg.num_levels, cfg.scale_factor)
    quotas = orb.features_per_level(cfg.num_features, cfg.num_levels, cfg.scale_factor)
    out = []
    for lvl, q in zip(levels, quotas):
        lvl = lvl.contiguous()
        xy, _, _ = orb._detect_level_batched(lvl, cfg.fast_threshold, q,
                                             cfg.edge_threshold, cfg.harris_block_size)
        out.append((lvl, brief.smooth_for_brief(lvl).contiguous(), xy.contiguous()))
    return out


def check_corner(frames, cfg, dev):
    from aria_slam_tpu_torch.ops.cuda import corner_kernel as ck

    worst = 0.0
    per_level = []
    for b in (3, 1):
        for lvl, _, _ in level_inputs(frames[:b], cfg, dev):
            got = ck.corner_rank_map_batched(lvl, cfg.fast_threshold, cfg.harris_block_size)
            want = ck.corner_rank_map_plain(lvl, cfg.fast_threshold, cfg.harris_block_size)
            mg, mw = got > -1e38, want > -1e38
            if not torch.equal(mg, mw):
                raise AssertionError(f"corner B={b} {tuple(lvl.shape)}: masks differ at "
                                     f"{int((mg != mw).sum())} pixels")
            rel = ((got[mg] - want[mg]).abs() / want[mg].abs().clamp(min=1.0)).max() \
                if mg.any() else torch.zeros(())
            err = float((got[mg] - want[mg]).abs().max()) if mg.any() else 0.0
            if float(rel) >= 1e-4:
                raise AssertionError(f"corner B={b} {tuple(lvl.shape)}: Harris rel diff {float(rel)}")
            worst = max(worst, err)
            if b == 1:
                per_level.append((lvl, int(mg.sum())))
    ms = launch_ms = plain_ms = bytes_ = ops = 0.0
    for lvl, _ in per_level:
        def kernel():
            return ck.corner_rank_map_batched(lvl, cfg.fast_threshold, cfg.harris_block_size)

        ms += graph_ms(kernel)
        launch_ms += cuda_ms(kernel, iters=50)
        plain_ms += graph_ms(lambda: ck.corner_rank_map_plain(lvl, cfg.fast_threshold,
                                                              cfg.harris_block_size),
                             iters=5, replays=4)
        bytes_ += 2 * 4 * lvl.numel()
        ops += CORNER_OPS_PER_PX * lvl.numel()
    bound_ms, by = bound(bytes_, ops, F32_OPS_PER_MS)
    log("kernels", f"corner: masks identical, Harris rel diff < 1e-4 on 8 levels x B=1,3 "
                   f"(max abs {worst:.3g}); per frame kernel {ms:.4f} ms ({launch_ms:.4f} ms with "
                   f"launch cost), plain {plain_ms:.4f} ms, "
                   f"bound {bound_ms:.5f} ms ({by}); corners per level "
                   f"{[c for _, c in per_level]}")
    return dict(name="corner_rank_map", route="cuda",
                source="aria_slam_tpu_torch/csrc/corner_kernel.cu",
                replaces="aria_slam_tpu/ops/pallas/corner_kernel.py:125",
                max_abs_err=worst, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=None, launch_ms=launch_ms)


def check_patch(frames, cfg, dev, rng):
    from aria_slam_tpu_torch.ops import brief
    from aria_slam_tpu_torch.ops.cuda import patch_kernel as pk

    r = brief.PATCH_R
    ms = launch_ms = plain_ms = lib_ms = bytes_ = 0.0
    for _, blurred, xy in level_inputs(frames[:1], cfg, dev):
        h, w = blurred.shape[-2:]
        # the detector's keypoints, plus centres anywhere (edges included)
        # to exercise the corner clamp and the edge repetition
        anywhere = torch.from_numpy(np.stack([rng.uniform(-3, w + 3, (1, 64)),
                                              rng.uniform(-3, h + 3, (1, 64))], -1)
                                    .astype(np.float32)).to(dev)
        for pts in (xy, anywhere):
            got = pk.extract_patches(blurred, pts, r)
            if not torch.equal(got, pk.extract_patches_plain(blurred, pts, r)):
                raise AssertionError(f"patch {(h, w)}: differs from the plain version")
        yy, xx = pk.patch_indices(blurred.shape, xy, r)
        bi = torch.zeros((1, 1, 1, 1), dtype=torch.long, device=dev)
        ms += graph_ms(lambda: pk.extract_patches(blurred, xy, r))
        launch_ms += cuda_ms(lambda: pk.extract_patches(blurred, xy, r), iters=50)
        plain_ms += graph_ms(lambda: pk.extract_patches_plain(blurred, xy, r))
        lib_ms += graph_ms(lambda: blurred[bi, yy, xx])
        # least traffic: the image pixels the patches cover, the centres,
        # the patches written
        covered = torch.zeros((h, w), dtype=torch.bool, device=dev)
        covered[yy.expand(-1, -1, -1, xx.shape[-1]), xx.expand(-1, -1, yy.shape[-2], -1)] = True
        bytes_ += 4 * int(covered.sum()) + xy.numel() * 4 + yy.numel() * xx.shape[-1] * 4
    bound_ms, by = bound(bytes_, 0.0, F32_OPS_PER_MS)
    log("kernels", f"patch: exactly equal on 8 levels (detector keypoints + edge centres); "
                   f"per frame kernel {ms:.4f} ms ({launch_ms:.4f} ms with launch cost), plain "
                   f"{plain_ms:.4f} ms, one indexing call "
                   f"{lib_ms:.4f} ms, bound {bound_ms:.5f} ms ({by})")
    return dict(name="extract_patches", route="cuda",
                source="aria_slam_tpu_torch/csrc/patch_kernel.cu",
                replaces="aria_slam_tpu/ops/pallas/patch_kernel.py:60",
                max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=by, library_ms=lib_ms, launch_ms=launch_ms)


# ----------------------------------------------------------------- slice
def run_slice(frames, gt, imu, cam):
    from aria_slam_tpu_torch.config import PipelineConfig
    from aria_slam_tpu_torch.eval import metrics
    from aria_slam_tpu_torch.ops.cuda import corner_kernel, match_kernel, patch_kernel
    from aria_slam_tpu_torch.pipeline import factory

    kernels = (corner_kernel.corner_rank_map_batched, patch_kernel.extract_patches,
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
    want = {"corner_rank_map_batched": 8 * n, "extract_patches": 8 * n,
            "match_top2_batched": n}
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
    ptxas = [ln.strip() for ln in report.splitlines()
             if "registers" in ln or "spill" in ln or "smem" in ln]
    log("build", f"3 kernel libraries in {secs:.1f} s; ptxas: " + " | ".join(ptxas))

    # 3. kernels vs plain
    cam = CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0)  # EuRoC intrinsics, no distortion
    t0 = time.perf_counter()
    frames, gt, imu = render_frames(cam, NUM_FRAMES, FPS)
    log("render", f"{NUM_FRAMES} frames {cam.width}x{cam.height} in "
                  f"{time.perf_counter() - t0:.1f} s")
    rng = np.random.default_rng(0)
    orb_cfg = OrbConfig()
    match_rec, extra = check_match(dev, rng)
    records = [check_corner(frames, orb_cfg, dev), check_patch(frames, orb_cfg, dev, rng),
               match_rec]

    # 4. the slice
    launches, slice_rec = run_slice(frames, gt, imu, cam)
    by_wrapper = {"corner_rank_map": "corner_rank_map_batched",
                  "extract_patches": "extract_patches", "match_top2": "match_top2_batched"}
    for r in records:
        r["launches"] = launches[by_wrapper[r["name"]]]
    if args.profile:
        extra["profile"] = profile_slice(frames, imu, cam)

    if args.out:
        with open(args.out, "w") as f:
            json.dump({"device": name, "nvidia_smi": smi, "kernels": records,
                       "slice": slice_rec, "build_s": secs, "ptxas": ptxas, **extra}, f,
                      indent=1)
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err", "ms",
            "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
