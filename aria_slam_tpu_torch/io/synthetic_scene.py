"""Synthetic scene renderer and ASL dataset writer (the port's numpy copy
of the JAX package's io/synthetic_scene.py: texture, trajectory,
multi-depth scene layers, the moving object and its projected box, frame
rendering, the IMU samples derived from the trajectory, and `generate`).

The reference warps textures with cv2.warpPerspective; this copy does
the same inverse-homography warp in numpy (source coordinates quantised
to 1/32 px and bilinear sampling with a zero border, as OpenCV does, and
a nearest-neighbour coverage mask), so frames can be made where OpenCV
is not installed. Frames agree with the reference's to about one grey
level. `generate` writes its PNGs with zlib (io/euroc.py).
"""

from __future__ import annotations

import os

import numpy as np

from aria_slam_tpu_torch.config import CameraConfig


def _texture(size=2048, seed=0):
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


def _rot_y(a):
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float64)


def trajectory(t, span=2.0, depth=4.0, loop=True, kind="sweep", period=20.0):
    """Smooth periodic path in front of the scene (world frame: camera
    starts at the origin looking +z). Returns pos (..., 3) and R
    world-from-camera (..., 3, 3)."""
    t = np.asarray(t, np.float64)
    w = 2 * np.pi / period
    x = span * np.sin(w * t)
    y = 0.35 * span * np.sin(2 * w * t)
    z = 0.25 * np.sin(w * t)
    pos = np.stack([x, y, z], -1)
    if kind == "rotloop":
        yaw = 0.6 * np.sin(3 * w * t)
    else:
        yaw = 0.12 * np.sin(w * t)
    R = np.stack([_rot_y(a) for a in np.atleast_1d(yaw)], 0)
    if np.isscalar(t) or t.ndim == 0:
        return pos.reshape(3), R[0]
    return pos, R


def _perspective_transform(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """3x3 homography mapping 4 src points onto 4 dst points (the
    linear system cv2.getPerspectiveTransform solves)."""
    a = np.zeros((8, 8))
    b = np.zeros(8)
    for i, ((x, y), (u, v)) in enumerate(zip(src.astype(np.float64),
                                             dst.astype(np.float64))):
        a[i] = [x, y, 1, 0, 0, 0, -x * u, -y * u]
        a[i + 4] = [0, 0, 0, x, y, 1, -x * v, -y * v]
        b[i], b[i + 4] = u, v
    return np.append(np.linalg.solve(a, b), 1.0).reshape(3, 3)


def _warp_plane(cam: CameraConfig, tex, corners_world, R_wc, pos):
    """Warp a texture onto the quad `corners_world` ((4, 3), CCW) via the
    exact plane homography. Returns (img, mask) uint8 or None if the quad
    is behind the camera."""
    R_cw = np.asarray(R_wc).T
    t_cw = -R_cw @ np.asarray(pos)
    K = cam.K.astype(np.float64)
    pc = corners_world @ R_cw.T + t_cw
    if np.any(pc[:, 2] < 0.2):
        return None
    uv = (pc[:, :2] / pc[:, 2:3]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    size = tex.shape[0]
    tex_corners = np.array([[0, 0], [size - 1, 0], [size - 1, size - 1], [0, size - 1]],
                           np.float32)
    M = np.linalg.inv(_perspective_transform(tex_corners, uv.astype(np.float32)))

    img = np.zeros((cam.height, cam.width), np.uint8)
    mask = np.zeros((cam.height, cam.width), np.uint8)
    # only the quad's bounding box (+2 px for rounding) can be covered
    x0 = max(int(np.floor(uv[:, 0].min())) - 2, 0)
    x1 = min(int(np.ceil(uv[:, 0].max())) + 3, cam.width)
    y0 = max(int(np.floor(uv[:, 1].min())) - 2, 0)
    y1 = min(int(np.ceil(uv[:, 1].max())) + 3, cam.height)
    if x1 <= x0 or y1 <= y0:
        return img, mask
    ys, xs = np.mgrid[y0:y1, x0:x1].astype(np.float64)
    den = M[2, 0] * xs + M[2, 1] * ys + M[2, 2]
    inv = np.where(den != 0, 1.0 / np.where(den != 0, den, 1.0), 0.0)
    sx = (M[0, 0] * xs + M[0, 1] * ys + M[0, 2]) * inv
    sy = (M[1, 0] * xs + M[1, 1] * ys + M[1, 2]) * inv

    # coverage: nearest source pixel inside the texture
    nx, ny = np.rint(sx), np.rint(sy)
    mask[y0:y1, x0:x1] = np.where((nx >= 0) & (nx < size) & (ny >= 0) & (ny < size),
                                  255, 0)

    # bilinear at 1/32-px quantised coordinates, zero outside the texture
    qx = np.rint(np.clip(sx, -1e6, 1e6) * 32).astype(np.int64)
    qy = np.rint(np.clip(sy, -1e6, 1e6) * 32).astype(np.int64)
    ix, iy = qx >> 5, qy >> 5
    ax, ay = (qx & 31) / 32.0, (qy & 31) / 32.0
    texf = tex.astype(np.float64)

    def tap(yy, xx):
        ok = (xx >= 0) & (xx < size) & (yy >= 0) & (yy < size)
        return np.where(ok, texf[np.clip(yy, 0, size - 1), np.clip(xx, 0, size - 1)], 0.0)

    val = ((1 - ay) * ((1 - ax) * tap(iy, ix) + ax * tap(iy, ix + 1))
           + ay * ((1 - ax) * tap(iy + 1, ix) + ax * tap(iy + 1, ix + 1)))
    img[y0:y1, x0:x1] = np.clip(np.floor(val + 0.5), 0, 255).astype(np.uint8)
    return img, mask


def scene_layers(depth=4.0, seed=0):
    """Multi-depth scene geometry: a far wall plus 15 textured panels at
    staggered depths (a single plane makes the essential matrix
    degenerate). Returns [(corners (4, 3), texture)] far to near."""
    rng = np.random.default_rng(seed + 11)
    layers = []

    def quad(cx, cy, z, hw, hh):
        return np.array([
            [cx - hw, cy - hh, z],
            [cx + hw, cy - hh, z],
            [cx + hw, cy + hh, z],
            [cx - hw, cy + hh, z],
        ])

    layers.append((quad(0.0, 0.0, depth + 5.0, 20.0, 20.0), _texture(2048, seed)))
    zs = [depth + 2.0, depth + 1.0, depth, depth - 1.2, depth - 2.0]
    for k, z in enumerate(zs):
        for _ in range(3):
            cx = rng.uniform(-5.0, 5.0)
            cy = rng.uniform(-2.5, 2.5)
            hw = rng.uniform(0.5, 1.3) * (z / depth)
            hh = rng.uniform(0.4, 1.0) * (z / depth)
            layers.append((quad(cx, cy, z, hw, hh),
                           _texture(512, seed + 100 + 7 * k + abs(int(cx * 31)))))
    return layers


def moving_object_state(t, depth=4.0, span=2.0, size=0.9, speed=1.0):
    """World corners ((4, 3), CCW) at time t of a textured panel that
    moves on its own path, decoupled from the camera: the dynamic-object
    stressor (reference: dynamic-object match filtering,
    src/main.cpp:29-50, 164-175). Its features obey another epipolar
    geometry than the static scene; slow apparent motion keeps many of
    them inside the RANSAC inlier gate, where they bias the estimate."""
    z = depth * 0.62
    # back and forth across the view (about 0.35 m/s at speed 1)
    period = 14.0 / max(speed, 1e-6)
    ph = 2.0 * np.pi * t / period
    cx = 0.62 * span * np.sin(ph)
    cy = 0.25 * np.sin(0.7 * ph) - 0.1
    hw = size * 0.62
    hh = size * 0.45
    return np.array([
        [cx - hw, cy - hh, z],
        [cx + hw, cy - hh, z],
        [cx + hw, cy + hh, z],
        [cx - hw, cy + hh, z],
    ])


def project_box(cam: CameraConfig, corners_world, R_wc, pos):
    """Axis-aligned pixel box (x1, y1, x2, y2) of a world quad, clipped
    to the image; None behind the camera or when under 2 px a side."""
    R_cw = np.asarray(R_wc).T
    t_cw = -R_cw @ np.asarray(pos)
    K = cam.K.astype(np.float64)
    pc = corners_world @ R_cw.T + t_cw
    if np.any(pc[:, 2] < 0.2):
        return None
    uv = (pc[:, :2] / pc[:, 2:3]) * [K[0, 0], K[1, 1]] + [K[0, 2], K[1, 2]]
    x1 = float(np.clip(uv[:, 0].min(), 0, cam.width - 1))
    x2 = float(np.clip(uv[:, 0].max(), 0, cam.width - 1))
    y1 = float(np.clip(uv[:, 1].min(), 0, cam.height - 1))
    y2 = float(np.clip(uv[:, 1].max(), 0, cam.height - 1))
    if x2 - x1 < 2 or y2 - y1 < 2:
        return None
    return x1, y1, x2, y2


def render_frame(cam: CameraConfig, tex, pos, R_wc, depth=4.0,
                 plane_half=8.0, layers=None):
    """Render the scene from the camera by exact per-plane homographies;
    the legacy single plane (z = depth) when `layers` is None."""
    if layers is None:
        corners = np.array([
            [-plane_half, -plane_half, depth],
            [plane_half, -plane_half, depth],
            [plane_half, plane_half, depth],
            [-plane_half, plane_half, depth],
        ])
        out = _warp_plane(cam, tex, corners, R_wc, pos)
        if out is None:
            return np.full((cam.height, cam.width), 70, np.uint8)
        return np.where(out[1] > 0, out[0], 70).astype(np.uint8)

    img = np.full((cam.height, cam.width), 70, np.uint8)
    for corners, ltex in layers:  # far -> near: near overwrites far
        out = _warp_plane(cam, ltex, corners, R_wc, pos)
        if out is not None:
            img = np.where(out[1] > 0, out[0], img)
    return img


def imu_samples(duration: float, imu_hz: float = 200.0, seed: int = 0,
                depth: float = 4.0, traj: str = "sweep", period: float = 20.0):
    """The reference generator's IMU stream for a trajectory: timestamps
    (M,) s, specific force (M, 3) and body rates (M, 3), by central
    differences, with its seeded noise."""
    n_imu = int(duration * imu_hz)
    ti = np.arange(1, n_imu + 1) / imu_hz
    dt = 1e-4
    pos_p, R_p = trajectory(ti - dt, depth=depth, kind=traj, period=period)
    pos_c, R_c = trajectory(ti, depth=depth, kind=traj, period=period)
    pos_n, R_n = trajectory(ti + dt, depth=depth, kind=traj, period=period)
    acc_world = (pos_n - 2 * pos_c + pos_p) / dt**2
    f_world = acc_world - np.array([0.0, 0.0, -9.81])
    f_body = np.einsum("nji,nj->ni", R_c, f_world)  # R^T f
    dR = np.einsum("nji,njk->nik", R_c, (R_n - R_p) / (2 * dt))  # R^T Rdot
    gyro = np.stack([dR[:, 2, 1], dR[:, 0, 2], dR[:, 1, 0]], -1)
    rng = np.random.default_rng(seed + 1)
    f_body = f_body + rng.normal(0, 0.01, f_body.shape)
    gyro = gyro + rng.normal(0, 0.001, gyro.shape)
    return ti, f_body, gyro


def _mat_to_quat_f32(R: np.ndarray) -> np.ndarray:
    """(N, 3, 3) float32 rotations -> (N, 4) (w, x, y, z) unit quaternions,
    w >= 0: core/lie.mat_to_quat's Shepperd construction in float32 numpy,
    whose square root is correctly rounded (torch's float32 sqrt on the
    CPU is not always), so the ground-truth file matches the reference's
    digit for digit."""
    f = np.float32
    m = [[R[:, i, j] for j in range(3)] for i in range(3)]
    tr = m[0][0] + m[1][1] + m[2][2]

    def part(x):
        q = np.sqrt(np.maximum(x, f(1e-24))) / f(2.0)
        return q, np.maximum(f(4.0) * q, f(1e-8))

    qw0, s0 = part(f(1.0) + tr)
    c0 = [qw0, (m[2][1] - m[1][2]) / s0, (m[0][2] - m[2][0]) / s0, (m[1][0] - m[0][1]) / s0]
    qx1, s1 = part(f(1.0) + m[0][0] - m[1][1] - m[2][2])
    c1 = [(m[2][1] - m[1][2]) / s1, qx1, (m[0][1] + m[1][0]) / s1, (m[0][2] + m[2][0]) / s1]
    qy2, s2 = part(f(1.0) - m[0][0] + m[1][1] - m[2][2])
    c2 = [(m[0][2] - m[2][0]) / s2, (m[0][1] + m[1][0]) / s2, qy2, (m[1][2] + m[2][1]) / s2]
    qz3, s3 = part(f(1.0) - m[0][0] - m[1][1] + m[2][2])
    c3 = [(m[1][0] - m[0][1]) / s3, (m[0][2] + m[2][0]) / s3, (m[1][2] + m[2][1]) / s3, qz3]
    cond1 = (m[0][0] > m[1][1]) & (m[0][0] > m[2][2])
    cond2 = m[1][1] > m[2][2]
    q = np.where((tr > 0)[:, None], np.stack(c0, -1),
                 np.where(cond1[:, None], np.stack(c1, -1),
                          np.where(cond2[:, None], np.stack(c2, -1), np.stack(c3, -1))))
    q = np.where(q[:, :1] < 0, -q, q)
    # the norm as the reference's compiled one sums it: a chain of fused
    # multiply-adds (exact float64 products, one rounding to float32 a step)
    ss = q[:, 0] * q[:, 0]
    for k in (1, 2, 3):
        ss = (q[:, k].astype(np.float64) ** 2 + ss).astype(f)
    return q / np.maximum(np.sqrt(ss), f(1e-8))[:, None]


def box_blur_rows(img: np.ndarray, k: int) -> np.ndarray:
    """OpenCV's cv2.blur(img, (k, 1)) of a uint8 image in numpy: the mean
    of k horizontal neighbours, the window from k // 2 left of the pixel
    (the default anchor), the border mirrored without repeating the edge
    pixel (BORDER_REFLECT_101), and OpenCV's uint8 rounding of the sum:
    half up, except at power-of-two widths, where it adds k / 2 + 1
    before the shift (checked against cv2 at widths 2 to 16)."""
    w = img.shape[1]
    pad = np.pad(img.astype(np.int64), ((0, 0), (k // 2, k - 1 - k // 2)), mode="reflect")
    s = sum(pad[:, j:j + w] for j in range(k))
    out = (s + k // 2 + 1) // k if k & (k - 1) == 0 else (2 * s + k) // (2 * k)
    return np.minimum(out, 255).astype(np.uint8)


def generate(
    out_dir: str,
    num_frames: int = 60,
    fps: float = 10.0,
    imu_hz: float = 200.0,
    cam: CameraConfig | None = None,
    seed: int = 0,
    depth: float = 4.0,
    traj: str = "sweep",
    occluder: bool = False,
    period: float = 20.0,
    structure: str = "layers",
    moving_object: bool = False,
    object_size: float = 0.9,
    object_speed: float = 1.0,
    noise_std: float = 0.0,
    exposure_drift: float = 0.0,
    motion_blur: int = 0,
) -> str:
    """Write an ASL dataset under out_dir/mav0 (cam0 PNGs, data.csv and
    sensor.yaml, imu0 with the reference generator's noise, ground truth
    at the IMU rate). Returns out_dir.

    traj: "sweep" | "rotloop" (see trajectory()); period: the revisit
    period in seconds; structure: "layers" (the multi-depth scene) or
    "plane" (a single plane, a degeneracy stress test); exposure_drift:
    sinusoidal gain amplitude over the period; occluder: a featureless
    block drifting across the view (texture hidden, then revealed, as by
    a passing foreground object), its grey level drawn from the
    reference's generator. moving_object: a textured panel on its own
    path (moving_object_state, object_size, object_speed) drawn over the
    scene; its ground-truth boxes go to mav0/cam0/boxes.csv (ts_ns, x1,
    y1, x2, y2), a row for each frame where it is in view. The
    photometric stressors, applied in this order: motion_blur, a
    horizontal box blur of that width in px (box_blur_rows, pan blur);
    exposure_drift; noise_std, per-pixel Gaussian sensor noise in grey
    levels, drawn from the occluder's generator after its draw of the
    same frame."""
    from aria_slam_tpu_torch.io.euroc import encode_png_gray8

    cam = cam or CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0)  # no distortion
    tex = _texture(seed=seed) if structure != "layers" else None
    layers = scene_layers(depth, seed) if structure == "layers" else None
    mav = os.path.join(out_dir, "mav0")
    cam_data = os.path.join(mav, "cam0", "data")
    os.makedirs(cam_data, exist_ok=True)
    os.makedirs(os.path.join(mav, "imu0"), exist_ok=True)
    os.makedirs(os.path.join(mav, "state_groundtruth_estimate0"), exist_ok=True)

    t0_ns = 1_400_000_000_000_000_000  # EuRoC-style epoch ns

    cam_rows = []
    box_rows = []
    obj_tex = _texture(512, seed + 999) if moving_object else None
    occ_rng = np.random.default_rng(seed + 7)
    for k in range(num_frames):
        t = k / fps
        ts_ns = t0_ns + int(round(t * 1e9))
        pos, R = trajectory(t, depth=depth, kind=traj, period=period)
        img = render_frame(cam, tex, pos, R, depth=depth, layers=layers)
        if moving_object:
            corners = moving_object_state(t, depth=depth, size=object_size, speed=object_speed)
            out = _warp_plane(cam, obj_tex, corners, R, pos)
            if out is not None:
                img = np.where(out[1] > 0, out[0], img)
                bb = project_box(cam, corners, R, pos)
                if bb is not None:
                    box_rows.append(f"{ts_ns},{bb[0]:.1f},{bb[1]:.1f},{bb[2]:.1f},{bb[3]:.1f}")
        if occluder:
            bw, bh = cam.width // 4, cam.height // 3
            cx = int((k * 7) % (cam.width + bw)) - bw // 2
            cy = cam.height // 2 + int(20 * np.sin(k / 9.0))
            x1, x2 = max(cx - bw // 2, 0), min(cx + bw // 2, cam.width)
            y1, y2 = max(cy - bh // 2, 0), min(cy + bh // 2, cam.height)
            if x2 > x1 and y2 > y1:
                img = img.copy()
                img[y1:y2, x1:x2] = int(occ_rng.uniform(35, 55))
        if motion_blur > 1:
            img = box_blur_rows(img, motion_blur)
        if exposure_drift > 0.0:
            gain = 1.0 + exposure_drift * np.sin(2 * np.pi * t / period)
            img = np.clip(img.astype(np.float32) * gain, 0, 255)
        if noise_std > 0.0:
            img = np.clip(img.astype(np.float32) + occ_rng.normal(0, noise_std, img.shape), 0, 255)
        fname = f"{ts_ns}.png"
        with open(os.path.join(cam_data, fname), "wb") as f:
            f.write(encode_png_gray8(img.astype(np.uint8)))
        cam_rows.append(f"{ts_ns},{fname}")
    with open(os.path.join(mav, "cam0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],filename\n")
        f.write("\n".join(cam_rows) + "\n")

    if moving_object:
        with open(os.path.join(mav, "cam0", "boxes.csv"), "w") as f:
            f.write("#timestamp [ns],x1,y1,x2,y2\n")
            f.write("\n".join(box_rows) + "\n")

    with open(os.path.join(mav, "cam0", "sensor.yaml"), "w") as f:
        f.write(
            "sensor_type: camera\n"
            f"resolution: [{cam.width}, {cam.height}]\n"
            "camera_model: pinhole\n"
            f"intrinsics: [{cam.fx}, {cam.fy}, {cam.cx}, {cam.cy}]\n"
            "distortion_model: radial-tangential\n"
            f"distortion_coefficients: [{cam.k1}, {cam.k2}, {cam.p1}, {cam.p2}]\n"
        )

    ti, f_body, gyro = imu_samples(num_frames / fps, imu_hz, seed, depth, traj, period)
    with open(os.path.join(mav, "imu0", "data.csv"), "w") as f:
        f.write("#timestamp [ns],w_x,w_y,w_z,a_x,a_y,a_z\n")
        for k in range(len(ti)):
            ts_ns = t0_ns + int(round(ti[k] * 1e9))
            f.write(f"{ts_ns},{gyro[k,0]:.9f},{gyro[k,1]:.9f},{gyro[k,2]:.9f},"
                    f"{f_body[k,0]:.9f},{f_body[k,1]:.9f},{f_body[k,2]:.9f}\n")

    # ground truth at the IMU rate
    pos_c, R_c = trajectory(ti, depth=depth, kind=traj, period=period)
    quats = _mat_to_quat_f32(R_c.astype(np.float32))
    with open(os.path.join(mav, "state_groundtruth_estimate0", "data.csv"), "w") as f:
        f.write("#timestamp, p_x, p_y, p_z, q_w, q_x, q_y, q_z\n")
        for k in range(len(ti)):
            ts_ns = t0_ns + int(round(ti[k] * 1e9))
            p, q = pos_c[k], quats[k]
            f.write(f"{ts_ns},{p[0]:.9f},{p[1]:.9f},{p[2]:.9f},"
                    f"{q[0]:.9f},{q[1]:.9f},{q[2]:.9f},{q[3]:.9f}\n")
    return out_dir
