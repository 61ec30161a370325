"""The benchmark's scene generator: a frozen copy of the port's synthetic
scene (io/synthetic_scene.py: `_texture`, `trajectory`, `scene_layers`,
`moving_object_state`, `_warp_plane` with `render_frame`, the moving
panel as `generate` draws it, and `imu_samples`), with the warp run on
the device in float64 for whole blocks of frames at once.

The warp is the port's inverse-homography warp step for step: the 8x8
perspective system on float32 corner pixels solved in float64, source
coordinates quantised to 1/32 px, bilinear sampling with a zero border,
a nearest-neighbour coverage mask limited to the quad's bounding box
plus its 2 px margin, far layers first. Textures and the IMU stream are
drawn by numpy, as the port draws them, so a seed gives the port's
scene. tests/test_slam_bench_scene.py holds it against the port.
"""

from __future__ import annotations

import numpy as np
import torch

# frames warped together: a block of 32 frames at 752x480 holds about a
# dozen float64 planes of 92 MB
BLOCK = 32


def texture(size=2048, seed=0):
    rng = np.random.default_rng(seed)
    tex = np.full((size, size), 90.0, np.float32)
    for _ in range(1800):
        y, x = rng.integers(0, size - 60, 2)
        h, w = rng.integers(8, 60, 2)
        tex[y: y + h, x: x + w] = rng.uniform(10, 245)
    gy = np.linspace(0, 25, size, dtype=np.float32)
    tex += gy[:, None]
    tex += rng.normal(0, 3.0, tex.shape).astype(np.float32)
    return np.clip(tex, 0, 255).astype(np.uint8)


def texture_drawn(size, rng):
    """`texture`'s kind of image with its draws made in a few vectorised
    calls of `rng` (another stream than `texture`'s, a tenth of its time)."""
    tex = np.full((size, size), 90.0, np.float32)
    ys, xs = rng.integers(0, size - 60, (2, 1800))
    hs, ws = rng.integers(8, 60, (2, 1800))
    vals = rng.uniform(10, 245, 1800)
    for y, x, h, w, v in zip(ys, xs, hs, ws, vals):
        tex[y: y + h, x: x + w] = v
    tex += np.linspace(0, 25, size, dtype=np.float32)[:, None]
    tex += 3.0 * rng.standard_normal((size, size), dtype=np.float32)
    return np.clip(tex, 0, 255).astype(np.uint8)


def layers_drawn(depth, rng):
    """`scene_layers`'s geometry with `texture_drawn` textures, all drawn
    from `rng`."""
    layers = [(_quad(0.0, 0.0, depth + 5.0, 20.0, 20.0), texture_drawn(2048, rng))]
    for z in (depth + 2.0, depth + 1.0, depth, depth - 1.2, depth - 2.0):
        for _ in range(3):
            cx, cy = rng.uniform(-5.0, 5.0), rng.uniform(-2.5, 2.5)
            hw = rng.uniform(0.5, 1.3) * (z / depth)
            hh = rng.uniform(0.4, 1.0) * (z / depth)
            layers.append((_quad(cx, cy, z, hw, hh), texture_drawn(512, rng)))
    return layers


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def trajectory(t, span=2.0, depth=4.0, kind="sweep", period=20.0):
    """pos (..., 3) and world-from-camera R (..., 3, 3) at times t (s)."""
    t = np.asarray(t, np.float64)
    w = 2 * np.pi / period
    x = span * np.sin(w * t)
    y = 0.35 * span * np.sin(2 * w * t)
    z = 0.25 * np.sin(w * t)
    pos = np.stack([x, y, z], -1)
    yaw = 0.6 * np.sin(3 * w * t) if kind == "rotloop" else 0.12 * np.sin(w * t)
    R = np.stack([_rot_y(a) for a in np.atleast_1d(yaw)], 0)
    if t.ndim == 0:
        return pos.reshape(3), R[0]
    return pos, R


def _quad(cx, cy, z, hw, hh):
    return np.array([[cx - hw, cy - hh, z], [cx + hw, cy - hh, z],
                     [cx + hw, cy + hh, z], [cx - hw, cy + hh, z]])


def scene_layers(depth=4.0, seed=0):
    """[(corners (4, 3), texture)] far to near: a far wall and 15 panels."""
    rng = np.random.default_rng(seed + 11)
    layers = [(_quad(0.0, 0.0, depth + 5.0, 20.0, 20.0), texture(2048, seed))]
    zs = [depth + 2.0, depth + 1.0, depth, depth - 1.2, depth - 2.0]
    for k, z in enumerate(zs):
        for _ in range(3):
            cx = rng.uniform(-5.0, 5.0)
            cy = rng.uniform(-2.5, 2.5)
            hw = rng.uniform(0.5, 1.3) * (z / depth)
            hh = rng.uniform(0.4, 1.0) * (z / depth)
            layers.append((_quad(cx, cy, z, hw, hh),
                           texture(512, seed + 100 + 7 * k + abs(int(cx * 31)))))
    return layers


def moving_object_state(t, depth=4.0, span=2.0, size=0.9, speed=1.0):
    """World corners (4, 3) of the moving panel at time t."""
    z = depth * 0.62
    period = 14.0 / max(speed, 1e-6)
    ph = 2.0 * np.pi * t / period
    cx = 0.62 * span * np.sin(ph)
    cy = 0.25 * np.sin(0.7 * ph) - 0.1
    return _quad(cx, cy, z, size * 0.62, size * 0.45)


def _perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src.astype(np.float64), dst.astype(np.float64))):
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def _plane_setup(cam, size, corners, R_wc, pos):
    """Host part of one plane in one frame: None when behind the camera,
    else (inverse homography (3, 3), bounding box (x0, x1, y0, y1))."""
    R_cw = np.asarray(R_wc).T
    t_cw = -R_cw @ np.asarray(pos)
    K = cam.K.astype(np.float64)
    pc = corners @ R_cw.T + t_cw
    if np.any(pc[:, 2] < 0.2):
        return None
    uv = (pc[:, :2] / pc[:, 2:3]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    tex_corners = np.array([[0, 0], [size - 1, 0], [size - 1, size - 1], [0, size - 1]],
                           np.float32)
    M = np.linalg.inv(_perspective_transform(tex_corners, uv.astype(np.float32)))
    box = (max(int(np.floor(uv[:, 0].min())) - 2, 0),
           min(int(np.ceil(uv[:, 0].max())) + 3, cam.width),
           max(int(np.floor(uv[:, 1].min())) - 2, 0),
           min(int(np.ceil(uv[:, 1].max())) + 3, cam.height))
    return M, box


def _warp_block(img, tex, Ms, boxes, live):
    """Draw one textured plane over a block of frames `img` (F, H, W)
    uint8 in place. Ms (F, 3, 3) float64, boxes (F, 4) int64, live (F,)."""
    dev = img.device
    f, h, w = img.shape
    size = tex.shape[0]
    ys = torch.arange(h, device=dev, dtype=torch.float64)[None, :, None]
    xs = torch.arange(w, device=dev, dtype=torch.float64)[None, None, :]
    M = [[Ms[:, i, j, None, None] for j in range(3)] for i in range(3)]
    den = M[2][0] * xs + M[2][1] * ys + M[2][2]
    nz = den != 0
    inv = torch.where(nz, 1.0 / torch.where(nz, den, 1.0), 0.0)
    sx = (M[0][0] * xs + M[0][1] * ys + M[0][2]) * inv
    sy = (M[1][0] * xs + M[1][1] * ys + M[1][2]) * inv
    del den, inv, nz
    nx, ny = torch.round(sx), torch.round(sy)
    yi = torch.arange(h, device=dev)[None, :, None]
    xi = torch.arange(w, device=dev)[None, None, :]
    b = boxes[:, :, None, None]
    in_box = (xi >= b[:, 0]) & (xi < b[:, 1]) & (yi >= b[:, 2]) & (yi < b[:, 3])
    cover = in_box & live[:, None, None] & (nx >= 0) & (nx < size) & (ny >= 0) & (ny < size)
    del nx, ny, in_box
    qx = torch.round(torch.clamp(sx, -1e6, 1e6) * 32).to(torch.int64)
    qy = torch.round(torch.clamp(sy, -1e6, 1e6) * 32).to(torch.int64)
    del sx, sy
    ix, iy = qx >> 5, qy >> 5
    ax, ay = (qx & 31) / 32.0, (qy & 31) / 32.0
    del qx, qy
    flat = tex.reshape(-1)

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < size) & (yy >= 0) & (yy < size)
        v = flat[(yy.clamp(0, size - 1) * size + xx.clamp(0, size - 1))]
        return torch.where(ok, v, 0.0)

    val = ((1 - ay) * ((1 - ax) * tap(iy, ix) + ax * tap(iy, ix + 1))
           + ay * ((1 - ax) * tap(iy + 1, ix) + ax * tap(iy + 1, ix + 1)))
    drawn = torch.clamp(torch.floor(val + 0.5), 0, 255).to(torch.uint8)
    img.copy_(torch.where(cover, drawn, img))


def render(cam, times, layers, kind="sweep", period=20.0, depth=4.0, moving=None,
           device="cuda") -> np.ndarray:
    """Frames (F, H, W) uint8 on the host at `times` (s): the scene
    `layers` along the trajectory `kind`, with the moving panel drawn
    over it when `moving` = (texture, size, speed)."""
    times = np.asarray(times, np.float64)
    pos, R = trajectory(times, depth=depth, kind=kind, period=period)
    planes = [(lambda t, c=c: c, tex) for c, tex in layers]
    if moving is not None:
        otex, osize, ospeed = moving
        planes.append((lambda t: moving_object_state(t, depth=depth, size=osize, speed=ospeed),
                       otex))
    texs = [torch.from_numpy(tex).to(device=device, dtype=torch.float64) for _, tex in planes]
    out = np.empty((len(times), cam.height, cam.width), np.uint8)
    for s in range(0, len(times), BLOCK):
        idx = range(s, min(s + BLOCK, len(times)))
        img = torch.full((len(idx), cam.height, cam.width), 70, dtype=torch.uint8, device=device)
        for (corners_at, tex_np), tex in zip(planes, texs):
            size = tex_np.shape[0]
            Ms = np.zeros((len(idx), 3, 3))
            boxes = np.zeros((len(idx), 4), np.int64)
            live = np.zeros(len(idx), bool)
            for j, k in enumerate(idx):
                got = _plane_setup(cam, size, corners_at(times[k]), R[k], pos[k])
                if got is not None:
                    Ms[j], boxes[j], live[j] = got[0], got[1], True
            if live.any():
                _warp_block(img, tex, torch.from_numpy(Ms).to(device),
                            torch.from_numpy(boxes).to(device), torch.from_numpy(live).to(device))
        out[s: s + len(idx)] = img.cpu().numpy()
    return out


def imu_samples(duration: float, imu_hz: float = 200.0, seed: int = 0,
                depth: float = 4.0, traj: str = "sweep", period: float = 20.0):
    """Timestamps (M,) s, specific force (M, 3), body rates (M, 3): central
    differences of the trajectory with the generator's seeded noise."""
    n_imu = int(duration * imu_hz)
    ti = np.arange(1, n_imu + 1) / imu_hz
    dt = 1e-4
    pos_p, R_p = trajectory(ti - dt, depth=depth, kind=traj, period=period)
    pos_c, R_c = trajectory(ti, depth=depth, kind=traj, period=period)
    pos_n, R_n = trajectory(ti + dt, depth=depth, kind=traj, period=period)
    acc_world = (pos_n - 2 * pos_c + pos_p) / dt**2
    f_world = acc_world - np.array([0.0, 0.0, -9.81])
    f_body = np.einsum("nji,nj->ni", R_c, f_world)
    dR = np.einsum("nji,njk->nik", R_c, (R_n - R_p) / (2 * dt))
    gyro = np.stack([dR[:, 2, 1], dR[:, 0, 2], dR[:, 1, 0]], -1)
    rng = np.random.default_rng(seed + 1)
    f_body = f_body + rng.normal(0, 0.01, f_body.shape)
    gyro = gyro + rng.normal(0, 0.001, gyro.shape)
    return ti, f_body, gyro


class Camera:
    """Pinhole intrinsics, EuRoC cam0 by default (no distortion)."""

    def __init__(self, width=752, height=480, fx=458.654, fy=457.296, cx=367.215, cy=248.375):
        self.width, self.height = int(width), int(height)
        self.fx, self.fy, self.cx, self.cy = fx, fy, cx, cy

    @property
    def K(self):
        return np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy], [0.0, 0.0, 1.0]],
                        np.float32)
