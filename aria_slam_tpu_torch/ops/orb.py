"""ORB front end: image(s) -> Features (counterpart of the JAX package's
ops/orb.py).

One corner kernel launch gives the rank maps of every pyramid level.
Per level, the 31-px border mask and a top-k select the level's
keypoints from its rank map. One patch kernel launch then cuts a 39x39
patch per keypoint of every level from the 5x5-blurred levels, and one
matmul over all of them gives the rBRIEF bits and the orientation.
Batched over (B, H, W) frames; the online pipeline uses B = 1. Feature
budgets per level follow ORB's geometric distribution and sum to
num_features.
"""

from __future__ import annotations

from typing import List

import torch

from aria_slam_tpu_torch.config import OrbConfig
from aria_slam_tpu_torch.core.types import Features
from aria_slam_tpu_torch.ops import brief
from aria_slam_tpu_torch.ops.cuda.corner_kernel import corner_rank_maps
from aria_slam_tpu_torch.ops.cuda.patch_kernel import extract_patches_levels
from aria_slam_tpu_torch.ops.pyramid import build_pyramid


# frames per BRIEF product (see extract_batch)
BRIEF_FRAMES = 4


def features_per_level(num_features: int, num_levels: int, scale_factor: float) -> List[int]:
    f = 1.0 / scale_factor
    raw = [f**i for i in range(num_levels)]
    total = sum(raw)
    ns = [max(8, int(round(num_features * r / total))) for r in raw]
    ns[0] += num_features - sum(ns)  # fix rounding drift on level 0
    return ns


def _select_keypoints(rank, top_k, border):
    """(B, H, W) rank map -> xy (B, K, 2), response (B, K), valid (B, K)."""
    bsz, h, w = rank.shape
    ys = torch.arange(h, device=rank.device)[:, None]
    xs = torch.arange(w, device=rank.device)[None, :]
    in_border = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)
    rank = torch.where(in_border[None], rank, float("-inf"))
    # exact top-k; the reference's approx_max_k is exact on the CPU and
    # differs only in the weakest corners on the TPU
    vals, idx = torch.topk(rank.reshape(bsz, h * w), top_k, dim=-1)
    xy = torch.stack([(idx % w).float(), (idx // w).float()], -1)
    valid = vals > -1e30
    return xy, torch.where(valid, vals, 0.0), valid


def extract_batch(imgs: torch.Tensor, cfg: OrbConfig) -> Features:
    """imgs: (B, H, W) float32 grayscale in [0, 255] -> Features with a
    leading batch axis, padded to cfg.num_features per frame."""
    bsz = imgs.shape[0]
    levels = build_pyramid(imgs, cfg.num_levels, cfg.scale_factor)
    quotas = features_per_level(cfg.num_features, cfg.num_levels, cfg.scale_factor)
    pattern = brief.brief_pattern(cfg.descriptor_bits, cfg.patch_size, cfg.brief_seed)

    ranks = corner_rank_maps(levels, cfg.fast_threshold, cfg.harris_block_size)
    xys, resps, valids = zip(*(_select_keypoints(rank, quota, cfg.edge_threshold)
                               for rank, quota in zip(ranks, quotas)))
    blurred = [brief.smooth_for_brief(limgs).contiguous() for limgs in levels]
    patches = extract_patches_levels(blurred, xys, brief.PATCH_R).flatten(2)  # (B, N, 39 * 39)
    # the BRIEF product's result is (frames, N, 30 * bits + 2) float32, 61 MB
    # a frame at 2000 features: a few frames at a time keeps a chunk of 33
    # frames from holding 2 GB at once (bits are differences of two bf16
    # pixels, exact whatever the grouping)
    parts = [brief.describe_and_orient(patches[s:s + BRIEF_FRAMES], pattern)
             for s in range(0, bsz, BRIEF_FRAMES)]
    desc = torch.cat([d for d, _ in parts])
    angle = torch.cat([a for _, a in parts])
    scales = [cfg.scale_factor**lvl for lvl in range(cfg.num_levels)]

    # per-level quotas sum exactly to num_features: concatenation gives
    # the padded feature set directly
    valid = torch.cat(valids, 1)
    dev = imgs.device
    return Features(
        xy=torch.cat([xy * scale for xy, scale in zip(xys, scales)], 1),
        response=torch.where(valid, torch.cat(resps, 1), 0.0),
        angle=angle,
        octave=torch.cat([torch.full((bsz, q), lvl, dtype=torch.int32, device=dev)
                          for lvl, q in enumerate(quotas)], 1),
        size=torch.cat([torch.full((bsz, q), cfg.patch_size * scale, dtype=torch.float32,
                                   device=dev) for q, scale in zip(quotas, scales)], 1),
        desc=desc * valid[..., None].to(torch.int8),
        valid=valid,
    )


def extract(img: torch.Tensor, cfg: OrbConfig) -> Features:
    """Single-frame wrapper: (H, W) -> Features (no batch axis)."""
    return extract_batch(img[None], cfg).map(lambda x: x[0])
