"""Least times of one launch of each of the port's kernels at a cell's
shapes, from a sample of the cell's own frames (the corner kernel's
operations and the patch kernel's bytes depend on the image)."""

from __future__ import annotations

import torch

from slam_bench import counts
from slam_bench.reference import orb as ref_orb


def extract_least_s(frames, orb_cfg: dict, batch: int):
    """frames (F, H, W) of the cell; batch: frames an extract launch
    takes. -> (corner s, patch s) a launch."""
    levels = ref_orb.pyramid(frames.to(torch.float32), orb_cfg["num_levels"],
                             orb_cfg["scale_factor"])
    ranks = [ref_orb.rank_map(lvl, orb_cfg["fast_threshold"], orb_cfg["harris_block_size"])
             for lvl in levels]
    ops = counts.corner_ops(levels, ranks, orb_cfg["fast_threshold"],
                            orb_cfg["harris_block_size"] // 2)
    nbytes = counts.corner_bytes(levels)
    f = frames.shape[0]
    corner = counts.bound(nbytes * batch / f, ops * batch / f, counts.F32_OPS_PER_S)
    quotas = ref_orb.quotas(orb_cfg["num_features"], orb_cfg["num_levels"],
                            orb_cfg["scale_factor"])
    blurred, xys = [], []
    e = orb_cfg["edge_threshold"]
    for lvl, rank, q in zip(levels, ranks, quotas):
        b, h, w = lvl.shape
        rank[:, :e] = float("-inf")
        rank[:, h - e:] = float("-inf")
        rank[:, :, :e] = float("-inf")
        rank[:, :, w - e:] = float("-inf")
        _, idx = torch.topk(rank.reshape(b, -1), q, dim=-1)
        xys.append(torch.stack([(idx % w).float(), (idx // w).float()], -1))
        blurred.append(ref_orb.separable(lvl, ref_orb.box_matrix(h), ref_orb.box_matrix(w)))
    patch = counts.bound(counts.patch_bytes(blurred, xys, ref_orb.PATCH_R) * batch / f, 0.0,
                         counts.F32_OPS_PER_S)
    return corner, patch
