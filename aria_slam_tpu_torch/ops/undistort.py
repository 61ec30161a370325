"""Radtan (plumb-bob) keypoint undistortion (counterpart of the JAX
package's ops/undistort.py): fixed-point inversion of the distortion
model, 10 iterations, fully vectorised."""

from __future__ import annotations

import torch

from aria_slam_tpu_torch.config import CameraConfig


def undistort_points(xy: torch.Tensor, cam: CameraConfig,
                     iterations: int = 10) -> torch.Tensor:
    """(..., 2) distorted pixel coords -> (..., 2) undistorted pixel
    coords (same pinhole K). No-op when all coefficients are zero."""
    if cam.k1 == cam.k2 == cam.p1 == cam.p2 == 0.0:
        return xy
    fx, fy, cx, cy = cam.fx, cam.fy, cam.cx, cam.cy
    k1, k2, p1, p2 = cam.k1, cam.k2, cam.p1, cam.p2

    xd = (xy[..., 0] - cx) / fx
    yd = (xy[..., 1] - cy) / fy

    x, y = xd, yd
    for _ in range(iterations):
        r2 = x * x + y * y
        radial = 1.0 + k1 * r2 + k2 * r2 * r2
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x = (xd - dx) / radial
        y = (yd - dy) / radial

    return torch.stack([x * fx + cx, y * fy + cy], -1)
