"""Data-parallel frame-pair front end (counterpart of the JAX package's
parallel/multiseq.py): B pairs of frames through ORB, the matcher and
RANSAC in one batched pass, and the same split over the mesh's "data"
ranks. The detector's data-parallel training step waits for the training
slice (ROADMAP.md queue 1).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from aria_slam_tpu_torch.config import PipelineConfig
from aria_slam_tpu_torch.ops import epipolar, match as match_ops, orb
from aria_slam_tpu_torch.parallel.mesh import Mesh, shard_rows


def batched_frontend(cfg: PipelineConfig):
    """run(img1s, img2s, sampler) -> (R (B, 3, 3), t (B, 3), num_inliers
    (B,)) for (B, H, W) frames (uint8 or float, cast on the device): both
    sides' ORB in one call each, one batched match and one RANSAC call
    for all B pairs. sampler: the RANSAC draws (ops/epipolar.py)."""
    def run(img1s, img2s, sampler):
        dev = img1s.device
        K = torch.as_tensor(cfg.camera.K, device=dev)
        f1 = orb.extract_batch(img1s.to(torch.float32), cfg.orb)
        f2 = orb.extract_batch(img2s.to(torch.float32), cfg.orb)
        m = match_ops.match_batched(f2, f1, cfg.matcher.ratio)
        tidx = m.train_idx.long()
        xy_prev = torch.take_along_dim(f1.xy, tidx[..., None], 1)
        valid = m.valid & torch.take_along_dim(f1.valid, tidx, 1)
        delta = epipolar.estimate_relative_pose(xy_prev, f2.xy, valid, K, cfg.ransac, sampler)
        return delta.R, delta.t, delta.num_inliers

    return run


def shard_batched_frontend(mesh: Mesh, cfg: PipelineConfig):
    """run(img1s, img2s, sampler) over the whole batch on every data
    rank: each rank runs its contiguous block of the B pairs (B a multiple
    of the data axis) and the results are gathered over the data axis, so
    every rank returns all B rows, in order. Collective over the data
    group."""
    fn = batched_frontend(cfg)

    def run(img1s, img2s, sampler):
        outs = fn(shard_rows(mesh, img1s, "data"), shard_rows(mesh, img2s, "data"), sampler)
        n = mesh.shape["data"]
        if n == 1:
            return outs
        gathered = []
        for x in outs:
            parts = [torch.empty_like(x) for _ in range(n)]
            dist.all_gather(parts, x.contiguous(), group=mesh.data_group)
            gathered.append(torch.cat(parts))
        return tuple(gathered)

    return run
