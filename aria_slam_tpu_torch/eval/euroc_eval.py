"""euroc_eval: offline evaluation on a EuRoC (ASL) sequence (counterpart
of the JAX package's eval/euroc_eval.py).

Parity: the reference src/euroc_eval.cpp. Chunk mode (--chunk N > 1)
runs the chunked evaluator (eval/chunked.py: VO, chunk BA, the IMU
metric scale, loop closure, the pose graph, mapping) over the sequence
in windows of N frame pairs, decoding the next window on a worker thread
(its PNGs in child processes) while the device runs the current one; then the final 50-iteration
optimisation, the offline EKF with its RTS smoother over the whole IMU
stream, ATE (Sim3, rigid, raw), RPE and the fused ATEs, and the exports
estimated_trajectory.txt, fused_trajectory.txt, map.ply, map.pcd (and
trajectory.png when matplotlib is installed). Online mode (--chunk 0,
the default) runs pipeline/slam_pipeline.SlamPipeline frame by frame, as
the reference does: VO, the EKF fusion inside every frame (its track is
the fused trajectory), loop closure with the pose-graph rebase and
mapping; then the same final optimisation, scores and exports.
--vo-only turns fusion, loop closure and mapping off, --no-loop loop
closure.

Usage:
    python -m aria_slam_tpu_torch.eval.euroc_eval <dataset_path> [--out DIR]
        [--max-frames N] [--vo-only] [--no-loop] [--config cfg.yaml]
        [--chunk N] [--profile DIR]

--profile traces the evaluation loop and the final optimisation with
torch.profiler into DIR (open with TensorBoard) and prints each span's
launches, device time and the device's idle time under it
(utils/profiling.attribute). Host-side stage times (decode, gyro prior, the
evaluator's stages, the EKF's forward pass and smoother) are always
reported as `stage_ms`.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from aria_slam_tpu_torch.config import PipelineConfig
from aria_slam_tpu_torch.eval import metrics
from aria_slam_tpu_torch.io import euroc
from aria_slam_tpu_torch.utils.profiling import (
    StageTimer, attribute, device_trace, format_attribution, span,
)

# The offline EKF runs event by event on this device, whatever device the
# evaluator runs on: each of its ~5,400 events (257 frames at 10 fps with
# a 200 Hz IMU) is a few dozen 15 x 15 tensor ops, which cost less on
# the host than as launches on the card (PERF.md, the eval phase of
# chip_smoke.py times both).
EKF_DEVICE = "cpu"

# Child processes that decode a chunk's PNGs (io/euroc.DecodeProcesses).
# One took 302-304 ms a chunk of 33 libpng-filtered 752x480 PNGs on the
# card's host, level with the fastest chunks (299 ms); the walk's time
# falls with its share of the chunk, so three take about half of that.
DECODE_PROCESSES = 3


def _run_chunked(data, config, chunk, n_frames, timer, decode_timer, verbose, t_start,
                 device, sampler, lc_diag):
    """The chunked evaluator over the sequence -> (pipe, skipped images,
    ms a frame of each chunk)."""
    from aria_slam_tpu_torch.eval.chunked import ChunkedSlam
    from aria_slam_tpu_torch.fusion import gyro_prior

    pipe = ChunkedSlam(config, chunk=chunk, timer=timer, device=device, sampler=sampler)
    if lc_diag:
        pipe.lc_diag = []
    frame_times = []
    bad_idx: set = set()   # unreadable image indices (a set: the chunk
    last_good = None       # overlap decodes boundary frames twice)

    def load_chunk(k):
        # one worker: calls never overlap, so the last-good carry is safe.
        # The worker only decodes; the main thread uploads.
        nonlocal last_good
        with span("decode", decode_timer):
            hi = min(k + chunk, n_frames - 1)
            idxs = list(range(k, hi + 1))
            if len(idxs) < chunk + 1:  # pad by repeating the last frame
                idxs = idxs + [idxs[-1]] * (chunk + 1 - len(idxs))
            # one batch, in the decode process: the row filters of the
            # chunk's PNGs come off together
            imgs = dict(zip(range(k, hi + 1), decode(data.image_paths[k:hi + 1])))
            frames = []
            for i in idxs:
                img = imgs[i]
                if img is None:
                    # an unreadable frame: the last good one stands in (an
                    # identity pair), as the reference reader skips and
                    # continues (EuRoCReader.cpp:287-291); last_good
                    # carries across chunks for a bad boundary frame
                    bad_idx.add(i)
                    img = (frames[-1] if frames
                           else last_good if last_good is not None
                           else np.zeros((data.camera.height, data.camera.width), np.uint8))
                else:
                    last_good = img
                frames.append(img)
            return np.stack(frames), [data.image_ts[i] for i in idxs], hi

    use_gyro = config.gyro_chain_rotation and len(data.imu_ts) > 0
    imu_window = ((data.imu_ts, data.imu_accel, data.imu_gyro)
                  if config.imu_metric_scale and len(data.imu_ts) > 0 else None)
    # The worker thread hands the PNG decode to child processes: images
    # with Average or Paeth rows (EuRoC's) cost the decoder an anti-
    # diagonal walk of some 37,000 small numpy calls a chunk, and in a
    # thread of this process their GIL hand-offs slowed the host-bound
    # chunks by 70-80 % on the card (PERF.md). decode_wait is the main
    # thread's wait for the next chunk's frames: 0 while the decode hides.
    with euroc.DecodeProcesses(DECODE_PROCESSES) as decode, ThreadPoolExecutor(1) as pool:
        k = 0
        fut = pool.submit(load_chunk, k)
        while k + 1 < n_frames:
            with span("decode_wait", timer):
                frames, ts, hi = fut.result()
            if hi + 1 < n_frames:
                fut = pool.submit(load_chunk, hi)
            gR = gok = None
            if use_gyro:
                with span("gyro_prior", timer):
                    gR, gok = gyro_prior.pair_rotations(data.imu_ts, data.imu_gyro, ts,
                                                        R_cam_imu=data.R_cam_imu)
            f0 = time.perf_counter()
            with span("device_chunk", timer):
                pipe.process_chunk(frames, ts, gR, gok, imu_window=imu_window)
            frame_times.append((time.perf_counter() - f0) / chunk)
            k = hi
            if verbose and (k + 1) % 96 < chunk:
                fps = (k + 1) / (time.perf_counter() - t_start)
                print(f"[{k + 1}/{n_frames}] fps={fps:.1f} "
                      f"map={int(pipe.map_state.count)} loops={pipe.num_loops}")
    pipe.trajectory = pipe.trajectory[:n_frames]  # drop the padding's duplicates
    return pipe, len(bad_idx), frame_times


def _run_online(data, config, n_frames, timer, decode_timer, verbose, t_start, device,
                sampler, detector):
    """The online pipeline frame by frame -> (pipe, skipped images, ms a
    frame, the EKF's positions a frame or None without fusion)."""
    from aria_slam_tpu_torch.pipeline import factory

    # through the factory, which builds the detector of enable_detection
    pipe = factory.create("cpu" if device.type == "cpu" else "gpu", config, device=device,
                          sampler=sampler, detector=detector)
    fused = [] if config.enable_fusion else None
    frame_times = []
    t_prev = -np.inf
    n_skipped = 0
    for k in range(n_frames):
        ts = data.image_ts[k]
        with span("decode", decode_timer):
            img = euroc.load_image_safe(data.image_paths[k])
        if img is None:  # skip and continue (EuRoCReader.cpp:287-291)
            n_skipped += 1
            continue
        imu_t, imu_a, imu_g = euroc.imu_window(data, t_prev, ts)
        with span("imu", timer):
            for j in range(len(imu_t)):
                pipe.process_imu(imu_t[j], imu_a[j], imu_g[j])
        f0 = time.perf_counter()
        with span("frame_step", timer):
            pipe.process_frame(img, ts)
        frame_times.append(time.perf_counter() - f0)
        if fused is not None:
            fused.append(pipe.last_output.fused_pos.cpu().numpy())
        t_prev = ts
        if verbose and (k + 1) % 100 == 0:
            fps = (k + 1) / (time.perf_counter() - t_start)
            print(f"[{k + 1}/{n_frames}] fps={fps:.1f} "
                  f"map={int(pipe.state.map_state.count)} loops={pipe.num_loops}")
    return pipe, n_skipped, frame_times, (np.stack(fused) if fused else None)


def ekf_inputs(data, trajectory) -> tuple:
    """The offline EKF's streams for a trajectory: the IMU samples its time
    span covers, and its poses as the VO input; float32 host arrays,
    times from its first pose. -> the first six arguments of
    fusion.ekf.run_sequence."""
    est_ts = np.array([t for t, _ in trajectory])
    t0 = float(est_ts[0])
    lo = np.searchsorted(data.imu_ts, est_ts[0])
    hi = np.searchsorted(data.imu_ts, est_ts[-1], side="right")
    vo_R = np.array([T[:3, :3] for _, T in trajectory], np.float32)
    vo_p = np.array([T[:3, 3] for _, T in trajectory], np.float32)
    return ((data.imu_ts[lo:hi] - t0).astype(np.float32), data.imu_accel[lo:hi].astype(np.float32),
            data.imu_gyro[lo:hi].astype(np.float32), (est_ts - t0).astype(np.float32), vo_R, vo_p)


def fuse(data, trajectory, config: PipelineConfig, timer=None) -> np.ndarray:
    """The offline EKF with its RTS smoother, on EKF_DEVICE, over the IMU
    samples that the trajectory's time span covers, with the trajectory
    (the final-optimised chain: a causal filter would lag it, the
    smoother uses the future too) as its VO input. -> (N, 3) fused
    positions."""
    from aria_slam_tpu_torch.fusion import ekf

    # host arrays, so run_sequence checks that both streams are sorted
    pos, _ = ekf.run_sequence(*ekf_inputs(data, trajectory), config.ekf, smooth=True,
                              device=EKF_DEVICE, timer=timer)
    return pos.cpu().numpy()


def run(dataset_path: str, out_dir: str = ".", max_frames: int | None = None,
        config: PipelineConfig | None = None, verbose: bool = True,
        chunk: int = 0, profile_dir: str | None = None,
        keep_pipe: bool = False, lc_diag: bool = False, device=None, sampler=None,
        detector=None) -> dict:
    """chunk > 1: the chunked offline evaluator; chunk = 0: the online
    per-frame pipeline. profile_dir: a torch.profiler trace of the loop
    and the final optimisation, and the launches, device and idle time by
    span printed. keep_pipe: the evaluator object under
    results['_pipe']. lc_diag: collect the chunked evaluator's
    loop-closure diagnostics (ChunkedSlam.lc_diag). device: CUDA unless
    given; sampler: RANSAC draws (see ops/epipolar.py), default a seeded
    torch generator. detector: the online pipeline's object detector
    (image -> Detections, run with enable_detection), default one built
    from config.detector_weights; chunk mode builds its own from the
    config. The offline EKF runs on EKF_DEVICE."""
    from aria_slam_tpu_torch.pipeline.slam_pipeline import resolve_device

    data = euroc.load(dataset_path)
    config = config or PipelineConfig()
    config = dataclasses.replace(config, camera=data.camera,
                                 imu_cam_rotation=tuple(map(tuple, data.R_cam_imu.tolist())))
    device = resolve_device(device)
    n_frames = len(data.image_paths)
    if max_frames:
        n_frames = min(n_frames, max_frames)

    t_start = time.perf_counter()
    timer = StageTimer(device=device)
    decode_timer = StageTimer()  # the decode worker never waits for the card
    chunked = bool(chunk and chunk > 1)
    fused_pos = None
    with device_trace(profile_dir, device) if profile_dir else contextlib.nullcontext() as prof:
        if chunked:
            pipe, n_skipped, frame_times = _run_chunked(
                data, config, chunk, n_frames, timer, decode_timer, verbose, t_start, device,
                sampler, lc_diag)
        else:
            # the online EKF ran in every frame step: its track is the
            # fused trajectory
            pipe, n_skipped, frame_times, fused_pos = _run_online(
                data, config, n_frames, timer, decode_timer, verbose, t_start, device, sampler,
                detector)
        pipe.finalize()

    # every frame unreadable leaves the trajectory empty: NaN metrics
    est_T = (np.stack([T for _, T in pipe.trajectory]) if pipe.trajectory
             else np.zeros((0, 4, 4), np.float32))
    est_ts = np.array([t for t, _ in pipe.trajectory])
    est_pos = est_T[:, :3, 3]

    # chunk mode fuses the IMU afterwards: the 15-state EKF over the whole
    # stream with the final-optimised chain as its VO input, smoothed (a
    # causal filter lags its input; offline the smoother uses the future)
    if chunked and config.enable_fusion and len(data.imu_ts) and len(est_ts):
        fused_pos = fuse(data, pipe.trajectory, config, timer=timer)

    scores, gt_pos, keep = metrics.associate_and_score(data, est_ts, est_T)
    est_kept = est_pos[keep] if keep else est_pos[:0]
    ate = scores["ate_rmse_m"]
    # median: robust to a one-off slow chunk (the first, the first verify)
    mean_frame_ms = float(np.median(frame_times[1:]) * 1000) if len(frame_times) > 1 else 0.0

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "estimated_trajectory.txt"), "w") as f:
        for t, T in pipe.trajectory:
            p = T[:3, 3]
            f.write(f"{t:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
    map_points = pipe.export_map(ply_path=os.path.join(out_dir, "map.ply"),
                                 pcd_path=os.path.join(out_dir, "map.pcd"))
    _plot(out_dir, est_pos, gt_pos, ate, verbose)

    results = {
        "frames": n_frames,
        "avg_fps": n_frames / (time.perf_counter() - t_start),
        "steady_frame_ms": mean_frame_ms,
        "loops": pipe.num_loops,
        "map_points": int(map_points),
        "ate_rmse_m": ate,
        "ate_raw_rmse_m": scores["ate_raw_rmse_m"],
        "rpe_rmse_m": scores["rpe_rmse_m"],
        "rpe_rot_deg": scores["rpe_rot_deg"],
        "skipped_images": n_skipped,
    }
    if len(gt_pos) >= 3:
        # scale diagnostics: the Sim3 ATE hides metric-scale errors, the
        # Umeyama scale (1.0 = metric) and the rigid ATE show them
        s_um, _, _ = metrics.align_umeyama(est_kept, gt_pos)
        results["umeyama_scale"] = float(s_um)
        results["ate_noscale_rmse_m"] = metrics.ate_rmse(est_kept, gt_pos, with_scale=False)
    if fused_pos is not None and len(gt_pos):
        results["ate_fused_rmse_m"] = metrics.ate_rmse(fused_pos[keep], gt_pos)
        results["ate_fused_noscale_rmse_m"] = metrics.ate_rmse(fused_pos[keep], gt_pos,
                                                               with_scale=False)
        results["ate_fused_raw_rmse_m"] = metrics.ate_rmse(fused_pos[keep], gt_pos, align=False)
        with open(os.path.join(out_dir, "fused_trajectory.txt"), "w") as f:
            for tt, p in zip(est_ts, fused_pos):
                f.write(f"{tt:.9f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
    # stage_ms means are steady-only (each stage's first event is in
    # stage_ms_warm); compile_wall_s sums the first events
    summary = {**timer.summary(), **decode_timer.summary()}
    for key, stat in (("stage_ms", "mean_ms"), ("stage_ms_p50", "p50_ms"),
                      ("stage_ms_warm", "warm_ms"), ("stage_ms_steady_total", "total_ms")):
        results[key] = {name: round(s[stat], 3) for name, s in summary.items()}
    results["stage_n"] = {name: s["count"] for name, s in summary.items()}
    results["compile_wall_s"] = round(
        (timer.warm_total_ms() + decode_timer.warm_total_ms()) / 1000.0, 3)
    if verbose:
        print("==== results ====")
        for k_, v in results.items():
            print(f"  {k_}: {v}")
        rep = "\n".join(r for r in (timer.report(), decode_timer.report()) if r)
        if rep:
            print("==== stage timing ====")
            print(rep)
        if profile_dir:
            print("==== launches, device and idle time by span ====")
            print(format_attribution(attribute(prof)))
            print(f"torch.profiler trace written to {profile_dir} (open with TensorBoard)")
    if keep_pipe:
        results["_pipe"] = pipe
    return results


def _plot(out_dir, est_pos, gt_pos, ate, verbose) -> None:
    """trajectory.png, an optional artefact: skipped without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        if verbose:
            print("trajectory.png skipped: matplotlib is not installed")
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(8, 6))
    ax.plot(est_pos[:, 0], est_pos[:, 1], label="estimated")
    if len(gt_pos):
        ax.plot(gt_pos[:, 0], gt_pos[:, 1], label="ground truth", alpha=0.7)
    ax.set_xlabel("x [m]")
    ax.set_ylabel("y [m]")
    ax.legend()
    ax.set_title(f"ATE RMSE: {ate:.3f} m")
    fig.savefig(os.path.join(out_dir, "trajectory.png"), dpi=100)
    plt.close(fig)


def main():
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("dataset", help="EuRoC sequence dir (contains mav0/)")
    ap.add_argument("--out", default="euroc_out")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--config", default=None, help="YAML config overrides")
    ap.add_argument("--vo-only", action="store_true",
                    help="disable fusion, loop closure and mapping")
    ap.add_argument("--no-loop", action="store_true")
    ap.add_argument("--chunk", type=int, default=0,
                    help=">1: chunked offline evaluation with this many frame pairs a chunk")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="torch.profiler trace of the evaluation loop into DIR "
                         "(bound it with --max-frames)")
    args = ap.parse_args()

    cfg = PipelineConfig.from_yaml(args.config) if args.config else PipelineConfig()
    if args.vo_only:
        cfg = dataclasses.replace(cfg, enable_fusion=False, enable_loop_closure=False,
                                  enable_mapping=False)
    if args.no_loop:
        cfg = dataclasses.replace(cfg, enable_loop_closure=False)
    run(args.dataset, args.out, args.max_frames, cfg, chunk=args.chunk,
        profile_dir=args.profile)


if __name__ == "__main__":
    main()
