"""Corner rank map: FAST-9 + 3x3 NMS + Harris in one pass (counterpart
of the JAX package's ops/pallas/corner_kernel.py).

`corner_rank_maps` takes every pyramid level at once: for CUDA tensors
it makes one launch of csrc/corner_kernel.cu for all levels and frames,
for CPU tensors it runs `corner_rank_map_plain` level by level.
`corner_rank_map_batched` (the JAX package's name) is its one-level
case. Both versions compute
on the image edge-replicated in every direction, as the TPU kernel does
(its 8-px edge halo and edge-padded alignment columns); the zero-padded
`ops.fast.rank_map_xla` differs from them only within a few pixels of
the border, which ORB's 31-px border mask discards.
"""

from __future__ import annotations

import torch

from aria_slam_tpu_torch.ops.cuda import _lib
from aria_slam_tpu_torch.ops.fast import ARC_LEN, FAST_RING

HALO = 8
NEG_INF = -3.0e38
MAX_BOX_R = 4  # the CUDA kernel's largest box radius (csrc MAX_R)


def _edge_pad(imgs: torch.Tensor, pad: int) -> torch.Tensor:
    """(B, H, W) -> (B, H + 2 pad, W + 2 pad) with edge replication."""
    _, h, w = imgs.shape
    iy = torch.arange(-pad, h + pad, device=imgs.device).clamp(0, h - 1)
    ix = torch.arange(-pad, w + pad, device=imgs.device).clamp(0, w - 1)
    return imgs[:, iy][:, :, ix]


def corner_rank_map_plain(imgs: torch.Tensor, threshold: float,
                          harris_block: int = 7,
                          harris_k: float = 0.04) -> torch.Tensor:
    """Plain PyTorch version of the kernel, with its operation order."""
    _, h, w = imgs.shape
    p = _edge_pad(imgs, HALO)

    def shifted(dy, dx, extra):
        """Pixel (y + dy, x + dx) for the output grid grown by `extra`."""
        return p[:, HALO + dy - extra: HALO + dy + h + extra,
                 HALO + dx - extra: HALO + dx + w + extra]

    # FAST-9 on the output grid plus one ring of NMS neighbours
    center = shifted(0, 0, 1)
    diffs = [shifted(dy, dx, 1) - center for (dx, dy) in FAST_RING]
    dext = diffs + diffs[: ARC_LEN - 1]
    bright = dark = None
    for s in range(16):
        mb, md = dext[s], -dext[s]
        for i in range(1, ARC_LEN):
            mb = torch.minimum(mb, dext[s + i])
            md = torch.minimum(md, -dext[s + i])
        bright = mb if bright is None else torch.maximum(bright, mb)
        dark = md if dark is None else torch.maximum(dark, md)
    score_ext = torch.clamp(torch.maximum(bright, dark) - threshold, min=0.0)

    score_c = score_ext[:, 1:-1, 1:-1]
    pooled = score_c
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            pooled = torch.maximum(pooled, score_ext[:, 1 + dy: 1 + dy + h,
                                                     1 + dx: 1 + dx + w])
    is_corner = (score_c >= pooled) & (score_c > 0.0)

    # Harris: Sobel on the grid grown by the box radius, then box sums
    r = harris_block // 2
    gx = (shifted(-1, 1, r) - shifted(-1, -1, r)
          + 2.0 * (shifted(0, 1, r) - shifted(0, -1, r))
          + shifted(1, 1, r) - shifted(1, -1, r))
    gy = (shifted(1, -1, r) - shifted(-1, -1, r)
          + 2.0 * (shifted(1, 0, r) - shifted(-1, 0, r))
          + shifted(1, 1, r) - shifted(-1, 1, r))

    def box(x):  # (B, h + 2r, w + 2r) -> (B, h, w): rows, then columns
        v = x[:, 0:h]
        for i in range(1, 2 * r + 1):
            v = v + x[:, i: i + h]
        s = v[:, :, r: r + w]
        for d in range(1, r + 1):
            s = s + v[:, :, r - d: r - d + w]
            s = s + v[:, :, r + d: r + d + w]
        return s

    sxx, syy, sxy = box(gx * gx), box(gy * gy), box(gx * gy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    harris = det - harris_k * tr * tr
    return torch.where(is_corner, harris, NEG_INF)


def corner_rank_maps(levels, threshold: float, harris_block: int = 7,
                     harris_k: float = 0.04) -> list:
    """List of (B, H_l, W_l) float32 images (one B, e.g. the levels of
    `build_pyramid`) -> their (B, H_l, W_l) rank maps: the Harris
    response where an NMS'd FAST corner fires, -3e38 elsewhere."""
    levels = list(levels)
    if all(lvl.device.type == "cpu" for lvl in levels):
        return [corner_rank_map_plain(lvl, threshold, harris_block, harris_k)
                for lvl in levels]
    r = harris_block // 2
    if harris_block % 2 != 1 or not 1 <= r <= MAX_BOX_R:
        raise ValueError(f"harris_block must be odd and at most {2 * MAX_BOX_R + 1}, "
                         f"got {harris_block}")
    if len(levels) > _lib.MAX_LEVELS:
        raise ValueError(f"the corner kernel takes at most {_lib.MAX_LEVELS} levels, "
                         f"got {len(levels)}")
    _lib.require_cuda(levels[0], "levels[0]", torch.float32, (None, None, None))
    b = levels[0].shape[0]
    table = _lib.CornerLevels(num_levels=len(levels))
    outs = []
    for i, lvl in enumerate(levels):
        _lib.require_cuda(lvl, f"levels[{i}]", torch.float32, (b, None, None))
        if lvl.device != levels[0].device:
            raise ValueError("all levels must lie on the same device")
        out = torch.empty_like(lvl)
        table.img[i], table.out[i] = lvl.data_ptr(), out.data_ptr()
        table.height[i], table.width[i] = lvl.shape[1], lvl.shape[2]
        outs.append(out)
    if b == 0:
        return outs
    code = _lib.library("corner").corner_rank_maps_launch(
        table, b, float(threshold), float(harris_k), r, _lib.stream_ptr(levels[0].device))
    _lib.check_launch(code, "corner")
    corner_rank_maps.launches += 1
    return outs


corner_rank_maps.launches = 0


def corner_rank_map_batched(imgs: torch.Tensor, threshold: float,
                            harris_block: int = 7,
                            harris_k: float = 0.04) -> torch.Tensor:
    """(B, H, W) float32 images -> (B, H, W) rank maps: one level of
    `corner_rank_maps`."""
    return corner_rank_maps([imgs], threshold, harris_block, harris_k)[0]


def corner_rank_map(img: torch.Tensor, threshold: float, harris_block: int = 7,
                    harris_k: float = 0.04) -> torch.Tensor:
    """(H, W) single-image wrapper."""
    return corner_rank_map_batched(img[None], threshold, harris_block, harris_k)[0]
