"""ORB front end: image(s) -> Features (counterpart of the JAX package's
ops/orb.py).

Per pyramid level: the corner kernel's rank map, the 31-px border mask
and a top-k select the level's keypoints; the patch kernel cuts a 39x39
patch per keypoint from the 5x5-blurred level; one matmul gives the
rBRIEF bits and the orientation. Batched over (B, H, W) frames; the
online pipeline uses B = 1. Feature budgets per level follow ORB's
geometric distribution and sum to num_features.
"""

from __future__ import annotations

from typing import List

import torch

from aria_slam_tpu_torch.config import OrbConfig
from aria_slam_tpu_torch.core.types import Features
from aria_slam_tpu_torch.ops import brief
from aria_slam_tpu_torch.ops.cuda.corner_kernel import corner_rank_map_batched
from aria_slam_tpu_torch.ops.cuda.patch_kernel import extract_patches
from aria_slam_tpu_torch.ops.pyramid import build_pyramid


def features_per_level(num_features: int, num_levels: int, scale_factor: float) -> List[int]:
    f = 1.0 / scale_factor
    raw = [f**i for i in range(num_levels)]
    total = sum(raw)
    ns = [max(8, int(round(num_features * r / total))) for r in raw]
    ns[0] += num_features - sum(ns)  # fix rounding drift on level 0
    return ns


def _detect_level_batched(imgs, threshold, top_k, border, harris_block):
    """(B, H, W) -> xy (B, K, 2), response (B, K), valid (B, K)."""
    bsz, h, w = imgs.shape
    rank = corner_rank_map_batched(imgs, threshold, harris_block)
    ys = torch.arange(h, device=imgs.device)[:, None]
    xs = torch.arange(w, device=imgs.device)[None, :]
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

    parts = {k: [] for k in ("xy", "resp", "angle", "oct", "size", "desc", "valid")}
    for lvl, (limgs, quota) in enumerate(zip(levels, quotas)):
        scale = cfg.scale_factor**lvl
        xy, resp, valid = _detect_level_batched(
            limgs, cfg.fast_threshold, quota, cfg.edge_threshold,
            cfg.harris_block_size)
        blurred = brief.smooth_for_brief(limgs).contiguous()
        patches = extract_patches(blurred, xy, brief.PATCH_R)  # (B, K, 39, 39)
        desc, ang = brief.describe_and_orient(patches.reshape(bsz, quota, -1), pattern)

        parts["xy"].append(xy * scale)
        parts["resp"].append(resp)
        parts["angle"].append(ang)
        parts["oct"].append(torch.full((bsz, quota), lvl, dtype=torch.int32,
                                       device=imgs.device))
        parts["size"].append(torch.full((bsz, quota), cfg.patch_size * scale,
                                        dtype=torch.float32, device=imgs.device))
        parts["desc"].append(desc)
        parts["valid"].append(valid)

    # per-level quotas sum exactly to num_features: concatenation gives
    # the padded feature set directly
    valid = torch.cat(parts["valid"], 1)
    return Features(
        xy=torch.cat(parts["xy"], 1),
        response=torch.where(valid, torch.cat(parts["resp"], 1), 0.0),
        angle=torch.cat(parts["angle"], 1),
        octave=torch.cat(parts["oct"], 1),
        size=torch.cat(parts["size"], 1),
        desc=torch.cat(parts["desc"], 1) * valid[..., None].to(torch.int8),
        valid=valid,
    )


def extract(img: torch.Tensor, cfg: OrbConfig) -> Features:
    """Single-frame wrapper: (H, W) -> Features (no batch axis)."""
    return extract_batch(img[None], cfg).map(lambda x: x[0])
