"""Two-view DLT triangulation (counterpart of the JAX package's
ops/triangulate.py; parity: cv::triangulatePoints).

A 4x4 DLT a correspondence: A p = 0 with rows u P[2] - P[0], v P[2] - P[1]
from both views, solved by the smallest eigenvector of A^T A. Every
function takes leading batch axes (projections (..., 3, 4), pixels
(..., N, 2)), so the lag pairs of a chunk triangulate in one call.

float32 conditioning: `triangulate_calibrated` solves in normalised
camera coordinates (K applied to the pixels, not to the projections)
with unit rows, which keeps A^T A well scaled; the pixel-space DLT loses
about 3 digits in float32, too many for the 2 px reprojection gate.
"""

from __future__ import annotations

import torch

from aria_slam_tpu_torch.ops.linalg import smallest_eigvec


def projection_matrix(K: torch.Tensor, T_cw: torch.Tensor) -> torch.Tensor:
    """P = K [R|t] from camera-from-world transforms (..., 4, 4) -> (..., 3, 4)."""
    return K @ T_cw[..., :3, :4]


def _dlt(P1, P2, p1, p2):
    """DLT on (..., 3, 4) projections and (..., N, 2) image coordinates
    -> (..., N, 3) points."""
    P1 = P1[..., None, :, :]  # (..., 1, 3, 4): broadcast over the N points
    P2 = P2[..., None, :, :]
    A = torch.stack([
        p1[..., 0:1] * P1[..., 2, :] - P1[..., 0, :],
        p1[..., 1:2] * P1[..., 2, :] - P1[..., 1, :],
        p2[..., 0:1] * P2[..., 2, :] - P2[..., 0, :],
        p2[..., 1:2] * P2[..., 2, :] - P2[..., 1, :],
    ], -2)  # (..., N, 4, 4)
    A = A / torch.clamp(torch.linalg.norm(A, dim=-1, keepdim=True), min=1e-12)
    X = smallest_eigvec(torch.einsum("...ki,...kj->...ij", A, A))
    w = X[..., 3]
    safe_w = torch.where(torch.abs(w) < 1e-10, 1e-10, w)
    return X[..., :3] / safe_w[..., None]


def triangulate_dlt(P1, P2, uv1, uv2) -> torch.Tensor:
    """P1, P2: (..., 3, 4) pixel projections; uv1, uv2: (..., N, 2) pixels
    -> (..., N, 3) world points. Prefer `triangulate_calibrated`."""
    return _dlt(P1, P2, uv1, uv2)


def triangulate_calibrated(K, T1_cw, T2_cw, uv1, uv2) -> torch.Tensor:
    """The well-conditioned float32 path: pixels normalised by K, [R|t]
    used directly. T*_cw (..., 4, 4) camera-from-world, uv* (..., N, 2)."""
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def norm(uv):
        return torch.stack([(uv[..., 0] - cx) / fx, (uv[..., 1] - cy) / fy], -1)

    return _dlt(T1_cw[..., :3, :4], T2_cw[..., :3, :4], norm(uv1), norm(uv2))
