"""Per-keypoint patch extraction (counterpart of the JAX package's
ops/pallas/patch_kernel.py).

`extract_patches_levels` takes every pyramid level at once: for CUDA
tensors it makes one launch of csrc/patch_kernel.cu for all levels and
frames, for CPU tensors it runs `extract_patches_plain` level by level.
`extract_patches` (the JAX package's name) is its one-level case. Both
versions clamp the patch CORNER (round(xy) - r) to the image and repeat
the last row/column past the bottom/right edge, as the TPU kernel does;
`ops.orient.gather_patches` clamps the centre instead, which agrees on
every keypoint inside ORB's 31-px border.
"""

from __future__ import annotations

import torch

from aria_slam_tpu_torch.ops.cuda import _lib

GROUP = 2        # keypoints a block (csrc G)
MAX_RADIUS = 19  # csrc MAX_R: patches of at most 39x39, as the TPU kernel's


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
    """Plain PyTorch version of the kernel, one level."""
    yy, xx = patch_indices(img.shape, xy, radius)
    bi = torch.arange(img.shape[0], device=img.device)[:, None, None, None]
    return img[bi, yy, xx]


def extract_patches_levels_plain(levels, xys, radius: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel: every level's patches,
    concatenated along the keypoint axis."""
    return torch.cat([extract_patches_plain(img, xy, radius)
                      for img, xy in zip(levels, xys)], 1)


def level_plan(keys):
    """(first_key, first_block) of the kernel's level table for levels of
    `keys` keypoints a frame: prefix sums of the keypoints (where a level's
    patches start in a frame's output) and of the blocks, GROUP keypoints
    a block (where its blocks start in a frame's share of the grid)."""
    first_key, first_block = [0], [0]
    for k in keys:
        first_key.append(first_key[-1] + k)
        first_block.append(first_block[-1] + -(-k // GROUP))
    return first_key, first_block


def extract_patches_levels(levels, xys, radius: int) -> torch.Tensor:
    """List of (B, H_l, W_l) float32 images and list of (B, K_l, 2)
    float32 level-local centres -> (B, sum K_l, S, S) float32 patches,
    S = 2 radius + 1, the levels concatenated in list order."""
    if len(levels) != len(xys):
        raise ValueError(f"{len(levels)} levels but {len(xys)} centre tensors")
    if all(t.is_cpu for t in levels) and all(t.is_cpu for t in xys):
        return extract_patches_levels_plain(levels, xys, radius)
    if not 0 <= radius <= MAX_RADIUS:
        raise ValueError(f"the patch kernel takes radius 0..{MAX_RADIUS}, got {radius}")
    if not 1 <= len(levels) <= _lib.MAX_LEVELS:
        raise ValueError(f"the patch kernel takes 1..{_lib.MAX_LEVELS} levels, "
                         f"got {len(levels)}")
    _lib.require_cuda(levels[0], "levels[0]", torch.float32, (None, None, None))
    b, dev = levels[0].shape[0], levels[0].get_device()
    imgs, ptrs, hs, ws, ks = [], [], [], [], []
    for i, (img, xy) in enumerate(zip(levels, xys)):
        _lib.require_cuda(img, f"levels[{i}]", torch.float32, (b, None, None))
        _lib.require_cuda(xy, f"xys[{i}]", torch.float32, (b, None, 2))
        if img.get_device() != dev or xy.get_device() != dev:
            raise ValueError("all levels and centres must lie on the same device")
        imgs.append(img.data_ptr())
        ptrs.append(xy.data_ptr())
        hs.append(img.shape[1])
        ws.append(img.shape[2])
        ks.append(xy.shape[1])
    first_key, first_block = level_plan(ks)
    size = 2 * radius + 1
    out = torch.empty((b, first_key[-1], size, size), dtype=torch.float32,
                      device=levels[0].device)
    if b == 0 or first_key[-1] == 0:
        return out
    n = len(levels)
    table = _lib.PatchLevels(num_levels=n)  # filled a field at a time: one slice each
    table.img[:n], table.xy[:n] = imgs, ptrs
    table.height[:n], table.width[:n], table.keys[:n] = hs, ws, ks
    table.first_key[:n + 1], table.first_block[:n + 1] = first_key, first_block
    code = _lib.library("patch").extract_patches_launch(table, out.data_ptr(), b, int(radius),
                                                        _lib.stream_ptr(out.device))
    _lib.check_launch(code, "patch")
    extract_patches_levels.launches += 1
    return out


extract_patches_levels.launches = 0


def extract_patches(img: torch.Tensor, xy: torch.Tensor, radius: int) -> torch.Tensor:
    """img (B, H, W) float32, xy (B, K, 2) float32 centres ->
    (B, K, S, S) float32 patches, S = 2 radius + 1: one level of
    `extract_patches_levels`."""
    return extract_patches_levels([img], [xy], radius)
