"""Keypoint patch gather (counterpart of the JAX package's ops/orient.py).

`gather_patches` is the reference's advanced-indexing gather with the
patch CENTRE clamped to the image; the ORB front end cuts its patches
with the patch kernel (ops/cuda/patch_kernel.py) instead.
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
