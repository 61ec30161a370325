"""Plain ORB: frames -> keypoints and rBRIEF descriptors, written from the
algorithm's description, the reference system's (OpenCV ORB as the JAX
package fixes it): an image pyramid of bilinear resampling at 1/1.2 a
level, FAST-9 corners on a 16-pixel ring with 3x3 non-maximum
suppression, ranked by the Harris response of a 7x7 box of Sobel
products; per level a fixed quota of the strongest corners outside a
31 px border; intensity-centroid orientation over a radius-15 disc and
256 steered binary tests on a 5x5-box-smoothed level, the steering
quantised to 12 degree bins. The resampling and smoothing round their
operands to bfloat16 and accumulate in float32, as the reference does
on purpose (its banded matmuls). Torch only; imports nothing of the
program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

RING = ((0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
        (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3))
ARC = 9
BINS = 30
PATCH_R = 19
PATCH_S = 2 * PATCH_R + 1


def bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def bilinear_matrix(n_out, n_in):
    m = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = min(max((i + 0.5) * scale - 0.5, 0.0), n_in - 1.0)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        m[i, lo] += 1.0 - (src - lo)
        m[i, hi] += src - lo
    return m


def box_matrix(n, size=5):
    m = np.zeros((n, n), np.float32)
    r = size // 2
    for i in range(n):
        for d in range(-r, r + 1):
            m[i, min(max(i + d, 0), n - 1)] += 1.0 / size
    return m


def separable(img, my, mx):
    """My @ img @ Mx^T on bf16-rounded operands, float32 accumulation."""
    my = bf16(torch.from_numpy(my).to(img.device))
    mx = bf16(torch.from_numpy(mx).to(img.device))
    return bf16(my @ bf16(img)) @ mx.T


def pyramid(img, levels, scale):
    h, w = img.shape[-2:]
    out = [img]
    for i in range(1, levels):
        s = scale ** i
        hi, wi = max(int(round(h / s)), 8), max(int(round(w / s)), 8)
        hp, wp = out[-1].shape[-2:]
        out.append(separable(out[-1], bilinear_matrix(hi, hp), bilinear_matrix(wi, wp)))
    return out


def _pad_edge(x, p):
    h, w = x.shape[-2:]
    iy = torch.arange(-p, h + p, device=x.device).clamp(0, h - 1)
    ix = torch.arange(-p, w + p, device=x.device).clamp(0, w - 1)
    return x[..., iy, :][..., ix]


def rank_map(img, threshold, block=7, k=0.04):
    """Harris response at 3x3-NMS'd FAST-9 corners, -inf elsewhere."""
    h, w = img.shape[-2:]
    p = _pad_edge(img, 8)

    def at(dy, dx):
        return p[..., 8 + dy: 8 + dy + h, 8 + dx: 8 + dx + w]

    diff = torch.stack([at(dy, dx) - img for dx, dy in RING], 0)
    ext = torch.cat([diff, diff[:ARC - 1]], 0)
    bright = torch.stack([ext[s: s + ARC].amin(0) for s in range(16)]).amax(0)
    dark = torch.stack([(-ext[s: s + ARC]).amin(0) for s in range(16)]).amax(0)
    score = torch.clamp(torch.maximum(bright, dark) - threshold, min=0.0)
    ps = torch.nn.functional.pad(score, (1, 1, 1, 1), value=float("-inf"))
    pooled = torch.stack([ps[..., 1 + dy: 1 + dy + h, 1 + dx: 1 + dx + w]
                          for dy in (-1, 0, 1) for dx in (-1, 0, 1)]).amax(0)
    corner = (score >= pooled) & (score > 0)
    gx = (at(-1, 1) - at(-1, -1)) + 2.0 * (at(0, 1) - at(0, -1)) + (at(1, 1) - at(1, -1))
    gy = (at(1, -1) - at(-1, -1)) + 2.0 * (at(1, 0) - at(-1, 0)) + (at(1, 1) - at(-1, 1))
    r = block // 2

    def box(x):
        q = torch.nn.functional.pad(x, (r, r, r, r))
        return sum(q[..., r + dy: r + dy + h, r + dx: r + dx + w]
                   for dy in range(-r, r + 1) for dx in range(-r, r + 1))

    sxx, syy, sxy = box(gx * gx), box(gy * gy), box(gx * gy)
    harris = sxx * syy - sxy * sxy - k * (sxx + syy) ** 2
    return torch.where(corner, harris, float("-inf"))


def quotas(n, levels, scale):
    raw = [(1.0 / scale) ** i for i in range(levels)]
    ns = [max(8, int(round(n * r / sum(raw)))) for r in raw]
    ns[0] += n - sum(ns)
    return ns


def pattern(bits=256, patch=31, seed=2024):
    """The reference's seeded Gaussian test pairs (bits, 2, 2)."""
    rng = np.random.default_rng(seed)
    pts = []
    while len(pts) < bits * 2:
        c = rng.normal(0.0, patch / 5.0, size=(bits * 4, 2))
        pts.extend(c[np.linalg.norm(c, axis=-1) <= 13.0].tolist())
    return np.asarray(pts[: bits * 2], np.float32).reshape(bits, 2, 2)


def test_matrix(pat):
    """(BINS * bits + 2, PATCH_S^2): per steering bin +1 at the second and
    -1 at the first point of each test; then the x and y moments of the
    radius-15 disc."""
    bits = pat.shape[0]
    sel = np.zeros((BINS, bits, PATCH_S * PATCH_S), np.float32)
    for b in range(BINS):
        a = 2.0 * np.pi * b / BINS
        rx = np.round(np.cos(a) * pat[..., 0] - np.sin(a) * pat[..., 1]).astype(int)
        ry = np.round(np.sin(a) * pat[..., 0] + np.cos(a) * pat[..., 1]).astype(int)
        lin = (ry + PATCH_R) * PATCH_S + (rx + PATCH_R)
        for i in range(bits):
            sel[b, i, lin[i, 0]] -= 1.0
            sel[b, i, lin[i, 1]] += 1.0
    mom = np.zeros((2, PATCH_S, PATCH_S), np.float32)
    for dy in range(-15, 16):
        for dx in range(-15, 16):
            if dx * dx + dy * dy <= 225:
                mom[0, PATCH_R + dy, PATCH_R + dx] = dx
                mom[1, PATCH_R + dy, PATCH_R + dx] = dy
    return np.concatenate([sel.reshape(BINS * bits, -1), mom.reshape(2, -1)], 0)


class Orb:
    """extract(frames (B, H, W)) -> dict(xy (B, N, 2), valid (B, N),
    desc (B, N, bits) int8 {0,1}, angle (B, N), tests (B, N, bits): each
    bit's test value, the second pixel less the first), level (B, N),
    response (B, N): the Harris response that ranked it),
    N = the budget,
    levels in order and each level's corners strongest first."""

    def __init__(self, cfg: dict, device):
        self.cfg = cfg
        self.quota = quotas(cfg["num_features"], cfg["num_levels"], cfg["scale_factor"])
        self.tests = bf16(torch.from_numpy(test_matrix(
            pattern(cfg["descriptor_bits"], cfg["patch_size"], cfg["brief_seed"]))).to(device))

    def extract(self, frames):
        cfg = self.cfg
        bits = cfg["descriptor_bits"]
        lv = pyramid(frames.to(torch.float32), cfg["num_levels"], cfg["scale_factor"])
        xys, valids, descs, angles, values, lv_ids, resps = [], [], [], [], [], [], []
        for i, (img, q) in enumerate(zip(lv, self.quota)):
            b, h, w = img.shape
            rank = rank_map(img, cfg["fast_threshold"], cfg["harris_block_size"])
            e = cfg["edge_threshold"]
            rank[:, :e] = float("-inf")
            rank[:, h - e:] = float("-inf")
            rank[:, :, :e] = float("-inf")
            rank[:, :, w - e:] = float("-inf")
            vals, idx = torch.topk(rank.reshape(b, -1), q, dim=-1)
            x, y = idx % w, idx // w
            smooth = separable(img, box_matrix(h), box_matrix(w))
            d = torch.arange(PATCH_S, device=img.device)
            x0 = torch.clamp(x - PATCH_R, 0, w - 1)
            y0 = torch.clamp(y - PATCH_R, 0, h - 1)
            yy = torch.clamp(y0[..., None, None] + d[:, None], max=h - 1)
            xx = torch.clamp(x0[..., None, None] + d[None, :], max=w - 1)
            bi = torch.arange(b, device=img.device)[:, None, None, None]
            patches = smooth[bi, yy, xx].reshape(b, q, -1)
            prod = bf16(patches) @ self.tests.T
            angle = torch.atan2(prod[..., -1], prod[..., -2])
            frac = torch.remainder(angle / (2 * math.pi), 1.0)
            abin = ((frac * BINS + 0.5).to(torch.int64) % BINS)
            tests = prod[..., :-2].reshape(b, q, BINS, bits)
            pick = torch.take_along_dim(tests, abin[..., None, None], 2)[..., 0, :]
            values.append(pick)
            lv_ids.append(torch.full((b, q), i, dtype=torch.int32, device=img.device))
            resps.append(torch.where(vals > -1e30, vals, 0.0))
            valid = vals > -1e30
            s = cfg["scale_factor"] ** i
            xys.append(torch.stack([x.float(), y.float()], -1) * s)
            valids.append(valid)
            descs.append((pick > 0).to(torch.int8) * valid[..., None].to(torch.int8))
            angles.append(angle)
        return dict(xy=torch.cat(xys, 1), valid=torch.cat(valids, 1),
                    desc=torch.cat(descs, 1), angle=torch.cat(angles, 1),
                    tests=torch.cat(values, 1), level=torch.cat(lv_ids, 1),
                    response=torch.cat(resps, 1))
