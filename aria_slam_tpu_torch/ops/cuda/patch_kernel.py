"""Per-keypoint patch extraction (counterpart of the JAX package's
ops/pallas/patch_kernel.py).

`extract_patches` launches csrc/patch_kernel.cu for CUDA tensors and runs
`extract_patches_plain` for CPU tensors. Both clamp the patch CORNER
(round(xy) - r) to the image and repeat the last row/column past the
bottom/right edge, as the TPU kernel does; `ops.orient.gather_patches`
clamps the centre instead, which agrees on every keypoint inside ORB's
31-px border.
"""

from __future__ import annotations

import torch

from aria_slam_tpu_torch.ops.cuda import _lib


def patch_indices(img_shape, xy: torch.Tensor, radius: int):
    """Row and column indices (B, K, S, 1), (B, K, 1, S) of every patch
    pixel, S = 2 radius + 1."""
    h, w = img_shape[-2:]
    d = torch.arange(2 * radius + 1, device=xy.device)
    x0 = torch.clamp(torch.round(xy[..., 0]).long() - radius, 0, w - 1)
    y0 = torch.clamp(torch.round(xy[..., 1]).long() - radius, 0, h - 1)
    yy = torch.clamp(y0[..., None, None] + d[:, None], max=h - 1)
    xx = torch.clamp(x0[..., None, None] + d[None, :], max=w - 1)
    return yy, xx


def extract_patches_plain(img: torch.Tensor, xy: torch.Tensor,
                          radius: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel."""
    yy, xx = patch_indices(img.shape, xy, radius)
    bi = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
    return img[bi, yy, xx]


def extract_patches(img: torch.Tensor, xy: torch.Tensor, radius: int) -> torch.Tensor:
    """img (B, H, W) float32, xy (B, K, 2) float32 centres ->
    (B, K, S, S) float32 patches, S = 2 radius + 1."""
    if img.device.type == "cpu":
        return extract_patches_plain(img, xy, radius)
    b, h, w = img.shape
    _lib.require_cuda(img, "img", torch.float32, (None, None, None))
    _lib.require_cuda(xy, "xy", torch.float32, (b, None, 2))
    if xy.device != img.device:
        raise ValueError("img and xy must lie on the same device")
    k = xy.shape[1]
    size = 2 * radius + 1
    out = torch.empty((b, k, size, size), dtype=torch.float32, device=img.device)
    if k == 0:
        return out
    code = _lib.library("patch").extract_patches_launch(
        img.data_ptr(), xy.data_ptr(), out.data_ptr(), b, h, w, k, int(radius),
        _lib.stream_ptr(img.device))
    _lib.check_launch(code, "patch")
    extract_patches.launches += 1
    return out


extract_patches.launches = 0
