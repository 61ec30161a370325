"""Image pyramid (counterpart of the JAX package's ops/pyramid.py).

Level sizes come from the config; resampling and box filtering are the
same dense banded matrices as the reference, applied as two matmuls.
No convolution is used anywhere: cuDNN would run a float32 convolution
in TF32 by default.
"""

from __future__ import annotations

import functools
from typing import List, Tuple

import numpy as np
import torch


@functools.lru_cache(maxsize=None)
def _bilinear_matrix(n_out: int, n_in: int) -> np.ndarray:
    """(n_out, n_in) row-stochastic bilinear interpolation matrix
    (align_corners=False convention)."""
    m = np.zeros((n_out, n_in), np.float32)
    scale = n_in / n_out
    for i in range(n_out):
        src = (i + 0.5) * scale - 0.5
        src = min(max(src, 0.0), n_in - 1.0)
        lo = int(np.floor(src))
        hi = min(lo + 1, n_in - 1)
        a = src - lo
        m[i, lo] += 1.0 - a
        m[i, hi] += a
    return m


@functools.lru_cache(maxsize=None)
def _box_matrix(n: int, size: int) -> np.ndarray:
    """(n, n) banded box-filter matrix with edge clamping."""
    r = size // 2
    m = np.zeros((n, n), np.float32)
    for i in range(n):
        for d in range(-r, r + 1):
            m[i, min(max(i + d, 0), n - 1)] += 1.0 / size
    return m


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    """Round float32 values to bfloat16 precision, kept as float32.

    The reference feeds bf16 operands to f32-accumulating matmuls; a
    float32 product of bf16-rounded operands reproduces that exactly up
    to summation order (a bf16 torch matmul would also round its output).
    """
    return x.to(torch.bfloat16).to(torch.float32)


# (id of a cached numpy matrix, device) -> (that matrix, its bf16-rounded
# device copy); holding the matrix keeps its id from being reused
_DEVICE_MATRICES: dict = {}


def _bf16_matrix(m: np.ndarray, device: torch.device) -> torch.Tensor:
    key = (id(m), str(device))
    if key not in _DEVICE_MATRICES:
        _DEVICE_MATRICES[key] = (m, round_bf16(torch.from_numpy(m).to(device)))
    return _DEVICE_MATRICES[key][1]


def _sep_matmul(img: torch.Tensor, my: np.ndarray, mx: np.ndarray) -> torch.Tensor:
    """out = My @ img @ Mx^T on bf16-rounded operands with float32
    accumulation, including the rounding of the intermediate product;
    img may carry leading batch axes."""
    a = _bf16_matrix(my, img.device) @ round_bf16(img)
    return round_bf16(a) @ _bf16_matrix(mx, img.device).T


def level_shape(h: int, w: int, scale_factor: float, level: int) -> Tuple[int, int]:
    s = scale_factor**level
    return max(int(round(h / s)), 8), max(int(round(w / s)), 8)


def build_pyramid(img: torch.Tensor, num_levels: int,
                  scale_factor: float) -> List[torch.Tensor]:
    """img: (..., H, W) float32 -> list of (..., Hi, Wi), level 0 = input."""
    h, w = img.shape[-2:]
    levels = [img]
    for i in range(1, num_levels):
        hi, wi = level_shape(h, w, scale_factor, i)
        hp, wp = levels[-1].shape[-2:]
        # cascaded from the previous level, like OpenCV
        levels.append(
            _sep_matmul(levels[-1], _bilinear_matrix(hi, hp), _bilinear_matrix(wi, wp))
        )
    return levels
