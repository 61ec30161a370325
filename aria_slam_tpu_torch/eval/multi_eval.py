"""Multi-sequence evaluation: S sequences through one batched front end
(counterpart of the JAX package's eval/multi_eval.py).

The VO front end of S sequences runs as one batched pass a chunk round:
the S * (C+1) frames go through ORB in one call (the sequence axis folds
into the kernels' batch axis), the S * C consecutive pairs through one
match launch and one gyro-fused RANSAC call, with their depth pins. The
host then chains each sequence's poses and scores it against its ground
truth. Loop closure and chunk BA keep per-sequence state and stay in the
single-sequence evaluator (eval/euroc_eval.py); this harness is for
sweeping many sequences or parameter variants at once.

With a mesh (parallel/mesh.py) the sequences split over its "data" ranks:
S is padded to a multiple of the data axis with copies of the last
sequence, each rank takes its contiguous block of the padded list and
decodes and runs only the real sequences in it (padded slots are
placeholders: no rank decodes or computes them), and the per-sequence
results are joined with one all_gather_object, so every rank returns
the S results in order. A rank touches only its own sequences inside a
round, so no collective runs there; a rank whose block is all padding
joins the final gather.

Each sequence draws its RANSAC samples from its own generator, seeded
from `seed` and the sequence's index, and every op of the front end
rounds a row the same in any batch (on the card the short contractions
of ops/linalg.py are a product and a sum, not a batched GEMM), so its
trajectory does not depend on the mesh or on where it sits in the batch:
bit for bit on the CPU (tests/test_torch_multi.py, one rank against two)
and on the card (chip_smoke.py, S = 4 against S = 1).

Usage (on the card; --cpu runs gloo ranks on the CPU):
    python -m aria_slam_tpu_torch.eval.multi_eval seq1 seq2 ... [--chunk 16]
        [--devices N] [--config cfg.yaml] [--out results.json] [--cpu]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from aria_slam_tpu_torch.config import PipelineConfig
from aria_slam_tpu_torch.eval.chunked import extract
from aria_slam_tpu_torch.eval.euroc_eval import DECODE_PROCESSES
from aria_slam_tpu_torch.ops import epipolar, match as match_ops
from aria_slam_tpu_torch.parallel import mesh as mesh_lib
from aria_slam_tpu_torch.pipeline.slam_pipeline import fetch_many, resolve_device

RANKS_TIMEOUT_S = 24 * 3600.0  # the spawned ranks of main(), all sequences together


def make_multi_chunk_frontend(cfg: PipelineConfig):
    """frontend(frames (S, C+1, H, W) uint8 on the device, sampler,
    gyro_R (S, C, 3, 3), gyro_ok (S, C)) -> (R, t, ok, pins, pin_oks),
    each with leading (S, C). S is the outer axis of every reshape, so
    pair (q, i) is frames (q, i) -> (q, i + 1). The translation is
    re-solved under the gyro rotation where there is one, as in
    eval/chunked.py, so (R, t) stay consistent. sampler: the RANSAC draws
    for the S * C pairs in (S, C) row-major order (ops/epipolar.py)."""
    focal = 0.5 * (cfg.camera.fx + cfg.camera.fy)
    in_thresh_sq = (cfg.ransac.inlier_threshold_px / focal) ** 2

    def frontend(frames, sampler, gyro_R, gyro_ok):
        s, cp1, h, w = frames.shape
        c = cp1 - 1
        K = torch.as_tensor(cfg.camera.K, dtype=torch.float32, device=frames.device)
        feats = extract(frames.reshape(s * cp1, h, w), cfg)
        feats = feats.map(lambda x: x.reshape(s, cp1, *x.shape[1:]))
        prev = feats.map(lambda x: x[:, :-1].reshape(s * c, *x.shape[2:]))
        cur = feats.map(lambda x: x[:, 1:].reshape(s * c, *x.shape[2:]))
        m = match_ops.match_batched(cur, prev, cfg.matcher.ratio)
        tidx = m.train_idx.long()
        xy_prev = torch.take_along_dim(prev.xy, tidx[..., None], 1)
        valid = m.valid & torch.take_along_dim(prev.valid, tidx, 1)
        delta = epipolar.estimate_pose_gyro_fused(
            xy_prev, cur.xy, valid, K, cfg.ransac, sampler, gyro_R.reshape(s * c, 3, 3),
            gyro_ok.reshape(s * c), in_thresh_sq)
        pz, pgood = epipolar.pin_depths(delta, xy_prev, cur.xy, valid, K,
                                        cfg.vo_pin_estimator, cfg.vo_pin_sigma_px)
        pins, pin_oks = epipolar.pin_scale(pz, pgood, cfg.vo_scene_depth)
        return tuple(x.reshape(s, c, *x.shape[1:])
                     for x in (delta.R, delta.t, delta.success, pins, pin_oks))

    return frontend


def sequence_seed(seed: int, index: int) -> int:
    """The seed of sequence `index`'s RANSAC generator."""
    return int(np.random.SeedSequence([seed, index]).generate_state(1)[0])


class SequenceSampler:
    """RANSAC draws for a batch whose leading axis is len(generators)
    equal blocks, one a sequence: each block draws from its own
    generator (ops/epipolar.TorchSampler), so a sequence's draws do not
    depend on the others in the batch."""

    def __init__(self, generators):
        self.samplers = [epipolar.TorchSampler(g) for g in generators]

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        blocks = valid.reshape(len(self.samplers), -1, *valid.shape[1:])
        return torch.cat([smp(v, num_hypotheses, sample_size, stage)
                          for smp, v in zip(self.samplers, blocks)])


def run_scenes(scene_dirs: Sequence[str], config: PipelineConfig | None = None,
               chunk: int = 16, mesh=None, seed: int = 0, verbose: bool = True,
               device=None, sampler=None, timer=None, keep_trajectories: bool = False) -> list:
    """Evaluate S sequences in lockstep chunk rounds; one result dict a
    sequence (sequence, frames, skipped_images and the scores of
    eval/metrics.associate_and_score; with keep_trajectories also its
    (frames, 4, 4) world-from-camera poses). Shorter sequences are padded
    with their last frame (identity pairs, skipped); an unreadable image
    is replaced by the sequence's last good one and counted. All
    sequences must share the camera intrinsics: mixed rigs raise
    ValueError. mesh: a parallel/mesh.Mesh to split the sequences over
    its data ranks (collective; runs on mesh.device); else one process on
    `device` (CUDA unless asked otherwise). sampler: replaces the
    per-sequence generators for the whole batch (tests replay the JAX
    package's draws with it). timer: a utils.profiling.StageTimer,
    charged "decode_wait" (the wait for the round's frames, decoded in
    child processes during the previous round), "frontend" (with the
    results' host read), "chain" and the whole "round" a round; the
    run's start (reading the sequences, starting the decode processes)
    and its scoring are outside every stage."""
    from aria_slam_tpu_torch.eval import metrics
    from aria_slam_tpu_torch.fusion import gyro_prior
    from aria_slam_tpu_torch.io import euroc

    datas = [euroc.load(d) for d in scene_dirs]
    s = len(datas)
    config = config or PipelineConfig()
    for q in range(1, s):
        if datas[q].camera != datas[0].camera:
            raise ValueError(
                f"multi_eval runs ONE camera model for the whole batch, but {scene_dirs[q]!r} "
                f"has different intrinsics than {scene_dirs[0]!r} ({datas[q].camera} vs "
                f"{datas[0].camera}); evaluate differing rigs in separate runs")
    config = dataclasses.replace(config, camera=datas[0].camera)
    n_frames = max(len(d.image_paths) for d in datas)
    dev = mesh.device if mesh is not None else resolve_device(device)
    frontend = make_multi_chunk_frontend(config)

    # this rank's contiguous block of the sequence list padded to the data axis
    slots = list(range(s))
    if mesh is not None:
        slots += [s - 1] * ((-s) % mesh.shape["data"])
        slots = mesh_lib.shard_rows(mesh, list(enumerate(slots)), "data")
        mine = [q for slot, q in slots if slot < s]
    else:
        mine = slots
    if sampler is None and mine:
        sampler = SequenceSampler([torch.Generator(device=dev).manual_seed(sequence_seed(seed, q))
                                   for q in mine])
    stage = timer.stage if timer is not None else (lambda name: contextlib.nullcontext())

    use_gyro = config.gyro_chain_rotation and all(len(d.imu_ts) for d in datas)
    T = {q: np.eye(4, dtype=np.float32) for q in mine}
    trajs = {q: [(datas[q].image_ts[0], np.eye(4, dtype=np.float32))] for q in mine}
    last_good = {q: None for q in mine}
    n_bad = {q: 0 for q in mine}

    def load_round(k):
        """The raw images of the round from frame k, every sequence of this
        rank, through the decode processes (on the prefetch thread)."""
        hi = min(k + chunk, n_frames - 1)
        idxs = list(range(k, hi + 1))
        idxs += [idxs[-1]] * (chunk + 1 - len(idxs))
        paths = [datas[q].image_paths[min(i, len(datas[q].image_paths) - 1)]
                 for q in mine for i in idxs]
        return hi, idxs, decode(paths)

    def stack(imgs):
        """(S_r, C+1, H, W) frames; an unreadable image is replaced by its
        sequence's last good one (the reference reader skips and
        continues), or black before the first."""
        out = []
        for j, q in enumerate(mine):
            seq = imgs[j * (chunk + 1):(j + 1) * (chunk + 1)]
            for i, img in enumerate(seq):
                if img is None:
                    n_bad[q] += 1
                    d = datas[q]
                    img = (np.zeros((d.camera.height, d.camera.width), np.uint8)
                           if last_good[q] is None else last_good[q])
                last_good[q] = seq[i] = img
            out.append(np.stack(seq))
        return np.stack(out)

    # the next round's PNGs decode in child processes while this round's
    # front end runs (as eval/euroc_eval.py's chunks); decode_wait is the
    # main thread's wait for them
    with contextlib.ExitStack() as ctx:
        if mine and n_frames > 1:
            decode = ctx.enter_context(euroc.DecodeProcesses(DECODE_PROCESSES))
            pool = ctx.enter_context(ThreadPoolExecutor(1))
            fut = pool.submit(load_round, 0)
        k = 0
        while mine and k + 1 < n_frames:
            with stage("round"):
                with stage("decode_wait"):
                    hi, idxs, imgs = fut.result()
                if hi + 1 < n_frames:
                    fut = pool.submit(load_round, hi)
                frames = stack(imgs)
                ts_all = {q: [datas[q].image_ts[min(i, len(datas[q].image_paths) - 1)]
                              for i in idxs] for q in mine}
                gRs = np.tile(np.eye(3, dtype=np.float32), (len(mine), chunk, 1, 1))
                goks = np.zeros((len(mine), chunk), bool)
                if use_gyro:
                    for j, q in enumerate(mine):
                        d = datas[q]
                        gRs[j], goks[j] = gyro_prior.pair_rotations(
                            d.imu_ts, d.imu_gyro, ts_all[q], R_cam_imu=d.R_cam_imu)
                with stage("frontend"):
                    R, t, ok, pins, pin_oks = fetch_many(frontend(
                        torch.from_numpy(frames).to(dev), sampler, torch.from_numpy(gRs).to(dev),
                        torch.from_numpy(goks).to(dev)))
                with stage("chain"):
                    for j, q in enumerate(mine):
                        d, ts = datas[q], ts_all[q]
                        for i in range(chunk):
                            if idxs[i + 1] >= len(d.image_paths) or idxs[i] == idxs[i + 1]:
                                continue  # padding
                            # a pair that failed even the gyro-seeded re-solve
                            # still chains the gyro rotation alone (as
                            # eval/chunked.py)
                            has_g = use_gyro and bool(goks[j, i])
                            if ok[j, i] or has_g:
                                Tcp = np.eye(4, dtype=np.float32)
                                Tcp[:3, :3] = R[j, i] if ok[j, i] else gRs[j, i]
                                if ok[j, i] and pin_oks[j, i]:
                                    Tcp[:3, 3] = t[j, i] * pins[j, i]
                                rel = np.linalg.inv(Tcp).astype(np.float32)
                            else:
                                rel = np.eye(4, dtype=np.float32)
                            T[q] = T[q] @ rel
                            trajs[q].append((ts[i + 1], T[q].copy()))
            k = hi
            if verbose:
                print(f"[{k + 1}/{n_frames}] x{len(mine)} sequences", flush=True)

    results = []
    for q in mine:
        est_ts = np.array([tt for tt, _ in trajs[q]])
        poses = np.stack([TT for _, TT in trajs[q]])
        scores, _, _ = metrics.associate_and_score(datas[q], est_ts, poses)
        res = {"sequence": scene_dirs[q], "frames": len(trajs[q]),
               "skipped_images": n_bad[q], **scores}
        if keep_trajectories:
            res["trajectory"] = poses
        results.append(res)
    if mesh is not None and mesh.shape["data"] > 1:
        parts = [None] * mesh.shape["data"]
        dist.all_gather_object(parts, results, group=mesh.data_group)
        results = [r for part in parts for r in part]
    if verbose:
        for res in results:
            print({k_: (round(v, 4) if isinstance(v, float) else v)
                   for k_, v in res.items() if k_ != "trajectory"}, flush=True)
    return results


def run_rank(rank: int, scene_dirs, config, chunk: int, seed: int, verbose: bool,
             keep_trajectories: bool = False) -> list:
    """One rank of a spawned mesh (parallel/mesh.spawn): the whole group
    as the data axis."""
    mesh = mesh_lib.make_mesh(n_model=1)
    return run_scenes(scene_dirs, config, chunk=chunk, mesh=mesh, seed=seed,
                      verbose=verbose and rank == 0, keep_trajectories=keep_trajectories)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("datasets", nargs="+", help="EuRoC sequence dirs")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--devices", type=int, default=0,
                    help="data-axis size (0 = every visible card; 1 with --cpu)")
    ap.add_argument("--cpu", action="store_true",
                    help="run gloo ranks on the CPU instead of NCCL ranks on the cards")
    ap.add_argument("--config", default=None)
    ap.add_argument("--out", default=None, metavar="JSON",
                    help="write per-sequence results as a JSON file")
    args = ap.parse_args(argv)

    cfg = PipelineConfig.from_yaml(args.config) if args.config else PipelineConfig()
    if args.cpu:
        backend, n = "gloo", args.devices or 1
    else:
        backend, visible = "nccl", torch.cuda.device_count()
        if visible == 0:
            raise RuntimeError("CUDA is not available; pass --cpu to run on the CPU")
        n = args.devices or visible
        if n > visible:
            raise ValueError(f"--devices {n} but only {visible} cards are visible")
    if n == 1:
        with mesh_lib.single_process_group(backend):
            results = run_rank(0, args.datasets, cfg, args.chunk, 0, True)
    else:
        results = mesh_lib.spawn(run_rank, n, backend, timeout_s=RANKS_TIMEOUT_S,
                                 args=(args.datasets, cfg, args.chunk, 0, True))[0]
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"mesh_devices": n, "backend": backend, "chunk": args.chunk,
                       "results": results}, f, indent=1)
        print(f"results written to {args.out}")
    return results


if __name__ == "__main__":
    main()
