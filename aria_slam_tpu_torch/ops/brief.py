"""Rotated BRIEF (rBRIEF) descriptors and intensity-centroid orientation
(counterpart of the JAX package's ops/brief.py).

The sampling pattern is the reference's seeded numpy pattern, byte for
byte. Steering uses 30 precomputed 12-degree bins: one matmul of the
flattened 39x39 patches against a (30 * 256 + 2, 1521) +1/-1 selection
matrix gives every bin's bit differences and the two orientation
moments; the keypoint's own bin is then picked. The reference rounds
both matmul operands to bf16; so does this port (float32 product of
bf16-rounded operands, see ops/pyramid.round_bf16).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from aria_slam_tpu_torch.ops.orient import gather_patches
from aria_slam_tpu_torch.ops.pyramid import _box_matrix, _sep_matmul, round_bf16

NUM_ANGLE_BINS = 30  # 12-degree steering quantization (ORB paper)
PATCH_R = 19         # covers |offset| <= 13 * sqrt(2) after rotation
PATCH_S = 2 * PATCH_R + 1


@functools.lru_cache(maxsize=None)
def brief_pattern(bits: int = 256, patch_size: int = 31, seed: int = 2024) -> np.ndarray:
    """(bits, 2, 2) float32: (pair, point, (x, y)) sampling offsets,
    Gaussian with sigma = patch_size / 5, rejected to |offset| <= 13."""
    rng = np.random.default_rng(seed)
    sigma = patch_size / 5.0
    max_r = 13.0
    pts = []
    while len(pts) < bits * 2:
        cand = rng.normal(0.0, sigma, size=(bits * 4, 2))
        cand = cand[np.linalg.norm(cand, axis=-1) <= max_r]
        pts.extend(cand.tolist())
    return np.asarray(pts[: bits * 2], np.float32).reshape(bits, 2, 2)


def _selection_matrix(pattern: np.ndarray) -> np.ndarray:
    """(NUM_ANGLE_BINS * bits, PATCH_S^2): +1 at p2's rotated cell and -1
    at p1's for every angle bin, so bit = (I[p1] < I[p2]) <=> row . patch > 0."""
    bits = pattern.shape[0]
    sel = np.zeros((NUM_ANGLE_BINS, bits, PATCH_S * PATCH_S), np.float32)
    for b in range(NUM_ANGLE_BINS):
        a = 2.0 * np.pi * b / NUM_ANGLE_BINS
        ca, sa = np.cos(a), np.sin(a)
        rx = np.round(ca * pattern[..., 0] - sa * pattern[..., 1]).astype(int)
        ry = np.round(sa * pattern[..., 0] + ca * pattern[..., 1]).astype(int)
        lin = (ry + PATCH_R) * PATCH_S + (rx + PATCH_R)  # (bits, 2)
        for i in range(bits):
            sel[b, i, lin[i, 0]] -= 1.0  # p1
            sel[b, i, lin[i, 1]] += 1.0  # p2
    return sel.reshape(NUM_ANGLE_BINS * bits, PATCH_S * PATCH_S)


@functools.lru_cache(maxsize=None)
def _moment_matrix(radius: int = 15) -> np.ndarray:
    """(2, PATCH_S^2) rows = [x * mask, y * mask] over the central
    circular window, so (m10, m01) come out of the BRIEF matmul."""
    m = np.zeros((2, PATCH_S, PATCH_S), np.float32)
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx * dx + dy * dy <= radius * radius:
                m[0, PATCH_R + dy, PATCH_R + dx] = dx
                m[1, PATCH_R + dy, PATCH_R + dx] = dy
    return m.reshape(2, PATCH_S * PATCH_S)


# (pattern bytes, device) -> bf16-rounded (30 * bits + 2, PATCH_S^2) matrix
_COMBINED: dict = {}


def _combined_matrix(pattern: np.ndarray, device) -> torch.Tensor:
    key = (pattern.tobytes(), str(device))
    if key not in _COMBINED:
        combined = np.concatenate([_selection_matrix(pattern), _moment_matrix()], 0)
        _COMBINED[key] = round_bf16(torch.from_numpy(combined).to(device))
    return _COMBINED[key]


def _pick_bits(diffs: torch.Tensor, angle: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., K, 30 * bits) bit differences of every angle bin -> the bits
    (..., K, bits) int8 of each keypoint's own bin."""
    diffs = diffs.reshape(diffs.shape[:-1] + (NUM_ANGLE_BINS, bits))
    bin_idx = angle_bin(angle)
    idx = bin_idx[..., None, None].expand(bin_idx.shape + (1, bits))
    picked = torch.gather(diffs, -2, idx)[..., 0, :]
    return (picked > 0).to(torch.int8)


def describe_and_orient(patches_flat: torch.Tensor, pattern: np.ndarray):
    """Fused rBRIEF + intensity-centroid orientation from flattened
    39x39 blurred patches (..., K, PATCH_S^2). Returns (bits (..., K, 256)
    int8, angle (..., K) float32)."""
    bits = pattern.shape[0]
    out = round_bf16(patches_flat) @ _combined_matrix(pattern, patches_flat.device).T
    angle = torch.atan2(out[..., -1], out[..., -2])  # (m01, m10)
    return _pick_bits(out[..., : NUM_ANGLE_BINS * bits], angle, bits), angle


def describe_from_patches(patches_flat: torch.Tensor, angle: torch.Tensor,
                          pattern: np.ndarray) -> torch.Tensor:
    """rBRIEF bits (..., K, bits) int8 of flattened 39x39 blurred patches
    (..., K, PATCH_S^2), steered by the given angles (..., K) in radians."""
    bits = pattern.shape[0]
    sel = _combined_matrix(pattern, patches_flat.device)[: NUM_ANGLE_BINS * bits]
    return _pick_bits(round_bf16(patches_flat) @ sel.T, angle, bits)


def describe(img: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor,
             pattern: np.ndarray) -> torch.Tensor:
    """rBRIEF bits (K, bits) int8 of keypoints xy (K, 2) at angles (K,) on
    one blurred level (H, W); patch centres clamped into the image
    (orient.gather_patches)."""
    patches = gather_patches(img, xy, PATCH_R).reshape(xy.shape[0], PATCH_S * PATCH_S)
    return describe_from_patches(patches, angle, pattern)


def angle_bin(angle: torch.Tensor) -> torch.Tensor:
    """The steering bin (int64, 0..NUM_ANGLE_BINS-1) of an orientation in
    radians: the nearest multiple of 12 degrees."""
    frac = torch.remainder(angle / (2.0 * np.pi), 1.0)
    return torch.clamp((frac * NUM_ANGLE_BINS + 0.5).to(torch.int64) % NUM_ANGLE_BINS,
                       0, NUM_ANGLE_BINS - 1)


def smooth_for_brief(img: torch.Tensor) -> torch.Tensor:
    """5x5 box smoothing before sampling, as two banded matmuls on
    bf16-rounded operands (edge-clamped, like the reference)."""
    h, w = img.shape[-2:]
    return _sep_matmul(img, _box_matrix(h, 5), _box_matrix(w, 5))


def pack_bits(desc: torch.Tensor) -> torch.Tensor:
    """(K, 256) {0,1} int8 -> (K, 8) packed words as int64, bit b of
    word i = bit 32 i + b (the bit order the match kernel packs in)."""
    k, bits = desc.shape
    if bits % 32:
        raise ValueError(f"bits must be a multiple of 32, got {bits}")
    d = desc.to(torch.int64).reshape(k, bits // 32, 32)
    shifts = torch.arange(32, device=desc.device)
    return (d << shifts).sum(-1)


def unpack_bits(packed: torch.Tensor, bits: int = 256) -> torch.Tensor:
    """(K, bits / 32) packed words (any integer dtype; the low 32 bits of
    each are read) -> (K, bits) {0,1} int8, the inverse of pack_bits."""
    shifts = torch.arange(32, device=packed.device)
    d = (packed.to(torch.int64)[:, :, None] >> shifts) & 1
    return d.reshape(packed.shape[0], bits).to(torch.int8)
