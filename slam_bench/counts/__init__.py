"""The least work of each counted piece of the port, worked out from
shapes and data: operations and bytes of the three CUDA kernels (corner
rank maps, patch extraction, top-2 Hamming matching), rBRIEF with its
angle and YOLO-s's convolutions, and the least time each takes on one H100 at
its published peaks (NVIDIA's data sheet, SXM part, dense): 3.35 TB/s of
HBM, 67 TFLOP/s float32 outside the tensor cores, 989 TFLOP/s bf16 and
1,979 TOP/s int8. The three kernel counts are those the port's kernel
table was worked out with (its chip smoke script's `corner_ops`,
`patch_bytes`, `match_bound`)."""

from __future__ import annotations

import torch

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
INT8_OPS_PER_S = 1979e12


def bound(nbytes: float, ops: float, ops_per_s: float) -> float:
    """Least seconds: the larger of the bytes and the operations bound."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)


def _edge_pad(imgs, pad):
    h, w = imgs.shape[-2:]
    iy = torch.arange(-pad, h + pad, device=imgs.device).clamp(0, h - 1)
    ix = torch.arange(-pad, w + pad, device=imgs.device).clamp(0, w - 1)
    return imgs[:, iy][:, :, ix]


def corner_ops(levels, ranks, threshold: float, box_r: int) -> int:
    """Float32 operations that the rank maps `ranks` of `levels` (each
    (B, H, W)) need on this data, done the cheapest way known, each step
    exact: at every pixel the compass test (4 ring differences, 8
    compares), which gives most pixels a score of exactly 0; at the pixels
    that pass it the rest of FAST-9 (12 differences, per polarity 64
    doubling-window and 15 arc min/max ops, one negation, 3 for the
    score); at the NMS survivors the NMS (9 maxima, 2 compares) and
    Harris, the cheaper of a dense pass (Sobel 14, products 3, separable
    box sums 3 x 4r, Harris 7 a pixel) and one window a survivor (Sobel
    and products at (2r+1)^2 pixels, three box sums, Harris)."""
    win = (2 * box_r + 1) ** 2
    ops = 0
    for lvl, rank in zip(levels, ranks):
        h, w = lvl.shape[-2:]
        p = _edge_pad(lvl, 3)
        c = p[:, 3: 3 + h, 3: 3 + w]
        n = [p[:, 3 + dy: 3 + dy + h, 3 + dx: 3 + dx + w] - c
             for dy, dx in ((-3, 0), (0, 3), (3, 0), (0, -3))]
        cand = ((sum((x > threshold).int() for x in n) >= 2)
                | (sum((x < -threshold).int() for x in n) >= 2))
        n_cand, n_corner = int(cand.sum()), int((rank > -1e38).sum())
        ops += 12 * lvl.numel() + (12 + 2 * (64 + 15) + 4) * n_cand + 11 * n_corner
        ops += min((14 + 3 + 12 * box_r + 7) * lvl.numel(),
                   (17 * win + 3 * (win - 1) + 7) * n_corner)
    return ops


def corner_bytes(levels) -> int:
    """Each level read once and its rank map written once, float32."""
    return sum(2 * 4 * lvl.numel() for lvl in levels)


def patch_indices(img_shape, xy, radius: int):
    """Row and column indices (B, K, S, 1), (B, K, 1, S) of every patch
    pixel, centres rounded and clamped into the image."""
    h, w = img_shape[-2:]
    d = torch.arange(2 * radius + 1, device=xy.device)
    x0 = torch.clamp(torch.round(xy[..., 0]).long() - radius, 0, w - 1)
    y0 = torch.clamp(torch.round(xy[..., 1]).long() - radius, 0, h - 1)
    yy = torch.clamp(y0[..., None, None] + d[:, None], max=h - 1)
    xx = torch.clamp(x0[..., None, None] + d[None, :], max=w - 1)
    return yy, xx


def patch_bytes(blurred, xys, radius: int = 19) -> int:
    """Least traffic of the patch kernel: the image pixels the patches
    cover, each read once, the centres, and the patches written."""
    nbytes = 0
    for img, xy in zip(blurred, xys):
        yy, xx = patch_indices(img.shape, xy, radius)
        b, h, w = img.shape
        covered = torch.zeros((b, h, w), dtype=torch.bool, device=img.device)
        bi = torch.arange(b, device=img.device)[:, None, None, None]
        covered[bi, yy.expand(-1, -1, -1, xx.shape[-1]), xx.expand(-1, -1, yy.shape[-2], -1)] = True
        nbytes += 4 * int(covered.sum()) + 4 * xy.numel() + 4 * yy.numel() * xx.shape[-1]
    return nbytes


def match_bound(n: int, kq: int, kt: int, bits: int = 256) -> float:
    """The match kernel's least seconds for n pairs of kq x kt descriptors
    of `bits` int8 bits: its inputs read and three int32 outputs written
    once, and a Hamming distance (an int8 product) for every pair."""
    nbytes = n * kq * bits + n * kt * bits + n * kt + 3 * 4 * n * kq
    return bound(nbytes, 2.0 * n * kq * kt * bits, INT8_OPS_PER_S)


def brief_least_s(keypoints: int, bits: int = 256, patch: int = 39, radius: int = 15) -> float:
    """rBRIEF with the intensity-centroid angle, done the cheapest way
    known: each keypoint's float32 patch read once, the two moments over
    the radius-15 disc (a multiply-add each a pixel and moment), one
    compare of two loaded pixels for each bit of the steering bin the
    angle picks, and the packed bits and the angle written. (The port
    multiplies every patch by all 30 bins' pair selectors, 23 MFLOP a
    keypoint; that is its choice, not the work the answer needs.)"""
    disc = sum(1 for y in range(-radius, radius + 1) for x in range(-radius, radius + 1)
               if x * x + y * y <= radius * radius)
    nbytes = keypoints * (4 * patch * patch + bits // 8 + 4)
    return bound(nbytes, keypoints * (2 * 2 * disc + bits), F32_OPS_PER_S)


def yolo_flops(size: int = 640, width: float = 0.5, depth: float = 0.33,
               num_classes: int = 80) -> float:
    """YOLO-s's convolution operations for one image (2 a multiply-add),
    from the reference model's shapes on the meta device."""
    from slam_bench.reference import yolo

    total = [0.0]

    def count(t, w_, stride, pad):
        out = torch.nn.functional.conv2d(t, w_, stride=stride, padding=pad)
        total[0] += 2.0 * out.numel() * w_.shape[1] * w_.shape[2] * w_.shape[3]
        return out

    W = {n: torch.empty(s, device="meta") for n, s, _ in yolo.params(width, depth, num_classes)}
    yolo.forward(W, torch.empty((1, 3, size, size), device="meta"), width, depth, num_classes,
                 conv_fn=count)
    return total[0]
