"""Map export: ASCII PLY and PCD with packed RGB (counterpart of the JAX
package's mapping/export.py).

Parity: the reference Mapper::exportPLY (src/legacy/Mapper.cpp:182-216)
and Mapper::exportPCD (Mapper.cpp:218-256). The map arrives on the host
in one copy of the padded buffers; the native writers
(aria_slam_tpu_torch/native.py, the repository's native/src/io.cpp)
format it, as the JAX package does. The numpy writers beside them write
the same bytes and are the plain versions the tests compare with.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from aria_slam_tpu_torch.core.types import MapState


def _live_points(m: MapState):
    valid = m.valid.cpu().numpy()
    pts = m.points.cpu().numpy()[valid]
    cols = np.clip(m.colors.cpu().numpy()[valid], 0.0, 1.0)
    return pts, cols


def export_ply(m: MapState, path: str) -> int:
    from aria_slam_tpu_torch import native

    pts, cols = _live_points(m)
    return native.write_ply(path, pts, (cols * 255).astype(np.uint8))


def export_pcd(m: MapState, path: str) -> int:
    from aria_slam_tpu_torch import native

    pts, cols = _live_points(m)
    return native.write_pcd(path, pts, (cols * 255).astype(np.uint8))


def write_ply_numpy(path: str, pts: np.ndarray, rgb: np.ndarray) -> int:
    """The plain PLY writer: (N, 3) float32 points, (N, 3) uint8 colours."""
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for p, c in zip(pts, rgb):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c[0]} {c[1]} {c[2]}\n")
    return len(pts)


def export_map(m: MapState, ply_path: Optional[str] = None,
               pcd_path: Optional[str] = None) -> int:
    """The map's live points to the given PLY and / or PCD file; their count."""
    n = 0
    if ply_path:
        n = export_ply(m, ply_path)
    if pcd_path:
        n = export_pcd(m, pcd_path)
    return n


def write_pcd_numpy(path: str, pts: np.ndarray, rgb: np.ndarray) -> int:
    """The plain PCD writer: colours packed into a float, as the reference."""
    rgb8 = rgb.astype(np.uint32)
    packed = (rgb8[:, 0] << 16) | (rgb8[:, 1] << 8) | rgb8[:, 2]
    packed_f = packed.view(np.float32) if len(packed) else packed.astype(np.float32)
    with open(path, "w") as f:
        f.write("# .PCD v0.7 - Point Cloud Data file format\n")
        f.write("VERSION 0.7\nFIELDS x y z rgb\nSIZE 4 4 4 4\nTYPE F F F F\n")
        f.write("COUNT 1 1 1 1\n")
        f.write(f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n")
        f.write(f"POINTS {len(pts)}\nDATA ascii\n")
        for p, c in zip(pts, packed_f):
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f} {c:.9e}\n")
    return len(pts)
