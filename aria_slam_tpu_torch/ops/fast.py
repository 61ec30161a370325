"""Dense FAST-9/16 corner detection + Harris ranking (counterpart of the
JAX package's ops/fast.py).

The ORB front end ranks corners with the fused corner kernel
(ops/cuda/corner_kernel.py). `rank_map_xla` is the reference's unfused,
zero-padded formulation, kept so the tests can hold the kernel's plain
version against it; convolutions are written as shifted slices (no
cuDNN, whose float32 convolutions default to TF32).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, (dx, dy), clockwise from 12 o'clock.
FAST_RING = (
    (0, -3), (1, -3), (2, -2), (3, -1),
    (3, 0), (3, 1), (2, 2), (1, 3),
    (0, 3), (-1, 3), (-2, 2), (-3, 1),
    (-3, 0), (-3, -1), (-2, -2), (-1, -3),
)

ARC_LEN = 9  # FAST-9


def _window(p: torch.Tensor, pad: int, dy: int, dx: int, h: int, w: int):
    return p[..., pad + dy: pad + dy + h, pad + dx: pad + dx + w]


def fast_score_map(img: torch.Tensor, threshold: float) -> torch.Tensor:
    """Dense FAST-9 score of (H, W): the best margin over 9-long arcs
    uniformly brighter or darker than the centre, minus the threshold;
    0 where not a corner. Edge-replicated ring."""
    h, w = img.shape[-2:]
    p = F.pad(img[None], (3, 3, 3, 3), mode="replicate")[0]
    ring = torch.stack([_window(p, 3, dy, dx, h, w) for (dx, dy) in FAST_RING], 0)
    diff = ring - img[None]
    dext = torch.cat([diff, diff[: ARC_LEN - 1]], 0)

    def window_min(x):
        m = x[:16]
        for i in range(1, ARC_LEN):
            m = torch.minimum(m, x[i: i + 16])
        return m

    bright = window_min(dext).amax(0)
    dark = window_min(-dext).amax(0)
    return torch.clamp(torch.maximum(bright, dark) - threshold, min=0.0)


def sobel_gradients(img: torch.Tensor):
    """(Ix, Iy) with 3x3 Sobel kernels, zero-padded."""
    h, w = img.shape[-2:]
    p = F.pad(img, (1, 1, 1, 1))

    def s(dy, dx):
        return _window(p, 1, dy, dx, h, w)

    ix = (s(-1, 1) - s(-1, -1)) + 2.0 * (s(0, 1) - s(0, -1)) + (s(1, 1) - s(1, -1))
    iy = (s(1, -1) - s(-1, -1)) + 2.0 * (s(1, 0) - s(-1, 0)) + (s(1, 1) - s(-1, 1))
    return ix, iy


def harris_response(img: torch.Tensor, block_size: int = 7, k: float = 0.04) -> torch.Tensor:
    """Dense Harris response (det - k tr^2 of the structure tensor), box
    sums zero-padded."""
    ix, iy = sobel_gradients(img)
    h, w = img.shape[-2:]
    r = block_size // 2

    def box(x):
        p = F.pad(x, (r, r, r, r))
        out = torch.zeros_like(x)
        for dy in range(-r, r + 1):
            for dx in range(-r, r + 1):
                out = out + _window(p, r, dy, dx, h, w)
        return out

    sxx, syy, sxy = box(ix * ix), box(iy * iy), box(ix * iy)
    det = sxx * syy - sxy * sxy
    tr = sxx + syy
    return det - k * tr * tr


def nms_3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep only local maxima in 3x3 neighbourhoods (-inf padded)."""
    h, w = score.shape[-2:]
    p = F.pad(score, (1, 1, 1, 1), value=float("-inf"))
    pooled = score
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            pooled = torch.maximum(pooled, _window(p, 1, dy, dx, h, w))
    return torch.where((score >= pooled) & (score > 0.0), score, 0.0)


def rank_map_xla(img: torch.Tensor, threshold: float,
                 harris_block: int = 7) -> torch.Tensor:
    """The reference's unfused corner rank map: Harris response at NMS'd
    FAST corners, -inf elsewhere."""
    score = nms_3x3(fast_score_map(img, threshold))
    harris = harris_response(img, harris_block)
    return torch.where(score > 0.0, harris, float("-inf"))
