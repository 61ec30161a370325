"""Keypoint orientation by intensity centroid and the patch gather
(counterpart of the JAX package's ops/orient.py).

`gather_patches` is the reference's advanced-indexing gather with the
patch CENTRE clamped to the image; the ORB front end cuts its patches
with the patch kernel (ops/cuda/patch_kernel.py) instead, and takes its
orientation from the BRIEF product (brief.describe_and_orient).
`orientations` is the reference's stand-alone angle: atan2(m01, m10)
over a radius-15 circular window, float32 sums.
"""

from __future__ import annotations

import torch

PATCH_RADIUS = 15


def gather_patches(img: torch.Tensor, xy: torch.Tensor,
                   radius: int = PATCH_RADIUS) -> torch.Tensor:
    """img (H, W), xy (K, 2) float level coords -> (K, 2r+1, 2r+1);
    centres clamped so padded keypoints read inside the image."""
    h, w = img.shape
    x0 = torch.clamp(torch.round(xy[:, 0]).long(), radius, w - radius - 1)
    y0 = torch.clamp(torch.round(xy[:, 1]).long(), radius, h - radius - 1)
    d = torch.arange(-radius, radius + 1, device=img.device)
    yy = y0[:, None, None] + d[None, :, None]
    xx = x0[:, None, None] + d[None, None, :]
    return img[yy, xx]


def orientations_from_patches(patches: torch.Tensor,
                              radius: int = PATCH_RADIUS) -> torch.Tensor:
    """Intensity-centroid angle (K,) of centred square patches (K, S, S),
    S >= 2 r + 1 (the central (2 r + 1)^2 window is used)."""
    off = (patches.shape[-1] - (2 * radius + 1)) // 2
    if off:
        patches = patches[:, off: off + 2 * radius + 1, off: off + 2 * radius + 1]
    coords = torch.arange(-radius, radius + 1, dtype=torch.float32, device=patches.device)
    ys, xs = coords[:, None], coords[None, :]
    wmask = ((ys * ys + xs * xs) <= radius * radius).to(torch.float32)
    m10 = (patches * (xs * wmask)).sum((1, 2))
    m01 = (patches * (ys * wmask)).sum((1, 2))
    return torch.atan2(m01, m10)


def orientations(img: torch.Tensor, xy: torch.Tensor,
                 radius: int = PATCH_RADIUS) -> torch.Tensor:
    """Intensity-centroid angle (K,) in radians of keypoints at level
    coordinates xy (K, 2) on img (H, W)."""
    return orientations_from_patches(gather_patches(img, xy, radius), radius)
