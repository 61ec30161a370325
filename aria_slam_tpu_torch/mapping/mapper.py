"""Sparse 3D mapping: triangulation and quality gates into a padded map
buffer (counterpart of the JAX package's mapping/mapper.py).

Parity: the reference Mapper (src/legacy/Mapper.cpp): DLT triangulation,
depth window [0.1, 50] m in both cameras, parallax >= 1 degree,
reprojection error <= 2 px in both views, grey colour from the first
image, 3-sigma statistical outlier removal, bounding box.

The map is a fixed-capacity MapState; an insert triangulates all
matches at once (leading pair axes allowed), computes every gate as a
tensor op and writes the survivors at the cursor, compacted and in
order, with no read on the host.
"""

from __future__ import annotations

import torch

from aria_slam_tpu_torch.config import MapperConfig
from aria_slam_tpu_torch.core.types import MapState
from aria_slam_tpu_torch.ops.triangulate import triangulate_calibrated


def init_map(cfg: MapperConfig, device) -> MapState:
    p = cfg.max_points
    return MapState(
        points=torch.zeros((p, 3), dtype=torch.float32, device=device),
        colors=torch.full((p, 3), 0.5, dtype=torch.float32, device=device),
        quality=torch.zeros((p,), dtype=torch.float32, device=device),
        valid=torch.zeros((p,), dtype=torch.bool, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def _transform(T, X):
    """Points (..., N, 3) through the rigid transforms (..., 4, 4)."""
    return X @ T[..., :3, :3].transpose(-1, -2) + T[..., None, :3, 3]


def triangulate_and_filter(K, T1_cw, T2_cw, uv1, uv2, valid, image1, cfg: MapperConfig):
    """Triangulate matched pixels and apply the reference's quality gates.

    T*_cw: camera-from-world (..., 4, 4); uv* (..., N, 2); valid (..., N);
    image1 (..., H, W) (uint8 or float grey levels) or None. Returns
    (points (..., N, 3) world, colors (..., N, 3), quality (..., N),
    keep (..., N) bool)."""
    X = triangulate_calibrated(K, T1_cw, T2_cw, uv1, uv2)
    R1, t1 = T1_cw[..., :3, :3], T1_cw[..., :3, 3]
    R2, t2 = T2_cw[..., :3, :3], T2_cw[..., :3, 3]
    Xc1 = _transform(T1_cw, X)
    Xc2 = _transform(T2_cw, X)

    # depth gates in both cameras (Mapper.cpp:65-68)
    keep = valid
    keep = keep & (Xc1[..., 2] > cfg.min_depth) & (Xc1[..., 2] < cfg.max_depth)
    keep = keep & (Xc2[..., 2] > cfg.min_depth) & (Xc2[..., 2] < cfg.max_depth)

    # parallax gate (Mapper.cpp:70-77)
    C1 = (-R1.transpose(-1, -2) @ t1[..., None])[..., 0]
    C2 = (-R2.transpose(-1, -2) @ t2[..., None])[..., 0]
    ray1 = X - C1[..., None, :]
    ray2 = X - C2[..., None, :]
    ray1 = ray1 / torch.clamp(torch.linalg.norm(ray1, dim=-1, keepdim=True), min=1e-9)
    ray2 = ray2 / torch.clamp(torch.linalg.norm(ray2, dim=-1, keepdim=True), min=1e-9)
    cos_par = torch.abs(torch.sum(ray1 * ray2, -1))
    parallax_deg = torch.rad2deg(torch.arccos(torch.clamp(cos_par, 0.0, 1.0)))
    keep = keep & (parallax_deg >= cfg.min_parallax_deg)

    # reprojection gates (Mapper.cpp:79-92)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]

    def reproj_err(Xc, uv):
        z = torch.clamp(Xc[..., 2], min=1e-9)
        u = fx * Xc[..., 0] / z + cx
        v = fy * Xc[..., 1] / z + cy
        return torch.hypot(u - uv[..., 0], v - uv[..., 1])

    err1 = reproj_err(Xc1, uv1)
    err2 = reproj_err(Xc2, uv2)
    keep = keep & (err1 <= cfg.max_reproj_error_px) & (err2 <= cfg.max_reproj_error_px)

    quality = 1.0 / (err1 + err2 + 0.1)  # Mapper.cpp:118

    if image1 is not None:
        # the pixel under uv1, truncated toward zero (as a cast to int32
        # does) and clipped to the image
        h, w = image1.shape[-2:]
        px = torch.clamp(uv1[..., 0].to(torch.int32), 0, w - 1).long()
        py = torch.clamp(uv1[..., 1].to(torch.int32), 0, h - 1).long()
        flat = image1.reshape(image1.shape[:-2] + (h * w,))
        # times the float32 reciprocal: the reference's compiled division
        # by the constant 255 rounds so
        gray = torch.gather(flat, -1, py * w + px).to(torch.float32) * (1.0 / 255.0)
        colors = torch.stack([gray, gray, gray], -1)
    else:
        colors = torch.full(X.shape, 0.5, dtype=torch.float32, device=X.device)
    return X, colors, quality, keep


def insert_points(m: MapState, points, colors, quality, keep) -> MapState:
    """Write the surviving points at the cursor, compacted and in order.
    points (N, 3), colors (N, 3), quality (N,), keep (N,).

    Each stored field becomes the first P rows of a (P + 1)-row buffer:
    dropped points and points past capacity go to its last, scratch row,
    so every index is in range and nothing is read on the host."""
    cap = m.points.shape[0]
    keep_i = keep.to(torch.int64)
    offsets = torch.cumsum(keep_i, 0) - keep_i  # rank among the survivors
    slots = m.count.to(torch.int64) + offsets
    slots = torch.where(keep & (slots < cap), slots, cap)

    def put(field, values):
        buf = torch.cat([field, field.new_zeros((1,) + field.shape[1:])])
        return buf.index_copy_(0, slots, values.to(field.dtype))[:cap]

    return MapState(
        points=put(m.points, points),
        colors=put(m.colors, colors),
        quality=put(m.quality, quality),
        valid=put(m.valid, torch.ones_like(keep)),
        count=torch.clamp(m.count + keep_i.sum().to(torch.int32), max=cap),
    )


def add_from_matches(m: MapState, K, T1_cw, T2_cw, uv1, uv2, valid, image1,
                     cfg: MapperConfig) -> MapState:
    """Parity: Mapper::triangulate (one call a frame pair)."""
    enough = valid.to(torch.int32).sum() >= 8  # Mapper.cpp:13
    pts, cols, qual, keep = triangulate_and_filter(K, T1_cw, T2_cw, uv1, uv2, valid, image1,
                                                   cfg)
    return insert_points(m, pts, cols, qual, keep & enough)


def add_from_matches_batched(m: MapState, K, T1s_cw, T2s_cw, uv1s, uv2s, valids, images,
                             cfg: MapperConfig) -> MapState:
    """The chunked evaluator's insert: C frame pairs at once (T*s (C, 4, 4),
    uv*s (C, N, 2), valids (C, N), images (C, H, W) or None), all
    survivors written in one update, pair by pair in order."""
    c, n = valids.shape
    enough = valids.to(torch.int32).sum(-1, keepdim=True) >= 8
    pts, cols, qual, keep = triangulate_and_filter(K, T1s_cw, T2s_cw, uv1s, uv2s, valids,
                                                   images, cfg)
    return insert_points(m, pts.reshape(c * n, 3), cols.reshape(c * n, 3),
                         qual.reshape(c * n), (keep & enough).reshape(c * n))


def filter_outliers(m: MapState, sigma: float = 3.0) -> MapState:
    """3-sigma statistical outlier removal on the distance to the centroid
    (parity: Mapper::filterOutliers, Mapper.cpp:134-165)."""
    vf = m.valid.to(torch.float32)
    n = torch.clamp(vf.sum(), min=1.0)
    centroid = torch.sum(m.points * vf[:, None], 0) / n
    d = torch.linalg.norm(m.points - centroid, dim=1)
    mean = torch.sum(d * vf) / n
    var = torch.sum((d - mean) ** 2 * vf) / n
    std = torch.sqrt(torch.clamp(var, min=1e-12))
    return m.replace(valid=m.valid & (d <= mean + sigma * std))


def filter_by_distance(m: MapState, max_dist: float, origin=None) -> MapState:
    """Parity: Mapper::filterByDistance."""
    origin = (torch.zeros(3, dtype=torch.float32, device=m.points.device)
              if origin is None else origin)
    d = torch.linalg.norm(m.points - origin, dim=1)
    return m.replace(valid=m.valid & (d <= max_dist))


def bounding_box(m: MapState):
    """Parity: Mapper::getBoundingBox (Mapper.cpp:258-269)."""
    big = 1e30
    lo = torch.where(m.valid[:, None], m.points, big).min(0).values
    hi = torch.where(m.valid[:, None], m.points, -big).max(0).values
    return lo, hi
