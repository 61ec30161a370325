"""EuRoC MAV (ASL format) dataset reader (counterpart of the JAX
package's io/euroc.py).

Parity: the reference EuRoCReader (src/legacy/EuRoCReader.cpp): the
mav0/{cam0, imu0, state_groundtruth_estimate0} CSVs sorted by
timestamp, ns -> s, cam0 intrinsics from sensor.yaml (the standard
EuRoC cam0 values when absent), the IMU batch in (prev_ts, ts], and
ground truth interpolated (linear position, slerp orientation).

Host side, numpy and the standard library only: CSVs through numpy,
8-bit greyscale PNGs decoded with zlib and numpy (all five row filters),
and sensor.yaml read by a small parser of the keys the reader uses, so
neither OpenCV nor PyYAML is needed.
"""

from __future__ import annotations

import os
import pickle
import re
import struct
import subprocess
import sys
import zlib
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

import numpy as np

from aria_slam_tpu_torch.config import CameraConfig

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


@dataclass
class EurocData:
    image_ts: np.ndarray          # (F,) float64 seconds
    image_paths: List[str]
    imu_ts: np.ndarray            # (M,) float64 seconds
    imu_gyro: np.ndarray          # (M, 3)
    imu_accel: np.ndarray         # (M, 3)
    gt_ts: np.ndarray             # (G,) float64 seconds
    gt_pos: np.ndarray            # (G, 3)
    gt_quat: np.ndarray           # (G, 4) (w, x, y, z)
    camera: CameraConfig = field(default_factory=CameraConfig)
    # camera-from-imu(body) rotation from cam0's T_BS: R_cam_imu =
    # R_BS[:3, :3]^T; identity when absent (synthetic scenes)
    R_cam_imu: np.ndarray = field(default_factory=lambda: np.eye(3))


def _read_csv(path: str, num_cols: int | None = None) -> np.ndarray:
    """A numeric CSV with '#' comment lines as a 2-D float64 array: the
    native parser (aria_slam_tpu_torch/native.py) when the column count is
    known, as the JAX package reads the IMU files, else (and for a file
    where it finds no row of num_cols numbers) the numpy reader."""
    if num_cols is not None:
        from aria_slam_tpu_torch import native

        out = native.parse_csv(path, num_cols)
        if len(out):
            return out
    return _read_csv_numpy(path, num_cols)


def _read_csv_numpy(path: str, num_cols: int | None = None) -> np.ndarray:
    """The plain reader of _read_csv (numpy.loadtxt)."""
    out = np.loadtxt(path, delimiter=",", comments="#", ndmin=2)
    if num_cols is not None and len(out) and out.shape[1] != num_cols:
        raise ValueError(f"{path}: {out.shape[1]} columns, expected {num_cols}")
    return out


def load(dataset_path: str) -> EurocData:
    mav = os.path.join(dataset_path, "mav0")
    if not os.path.isdir(mav):
        mav = dataset_path  # allow pointing directly at mav0

    cam_dir = os.path.join(mav, "cam0")
    cam_csv = os.path.join(cam_dir, "data.csv")
    if not os.path.exists(cam_csv):
        raise FileNotFoundError(
            f"not an ASL/EuRoC dataset: missing {cam_csv} "
            f"(expected <dataset>/mav0/cam0/data.csv)")
    rows = []
    with open(cam_csv) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ts_str, fname = line.split(",")[:2]
            rows.append((int(ts_str), fname.strip()))
    rows.sort()
    image_ts = np.array([r[0] for r in rows], np.float64) * 1e-9
    image_paths = [os.path.join(cam_dir, "data", r[1]) for r in rows]

    imu = _read_csv(os.path.join(mav, "imu0", "data.csv"), 7)
    imu = imu[np.argsort(imu[:, 0])]

    gt_csv = os.path.join(mav, "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_csv):
        gt = _read_csv(gt_csv)
        gt = gt[np.argsort(gt[:, 0])]
        gt_ts, gt_pos, gt_quat = gt[:, 0] * 1e-9, gt[:, 1:4], gt[:, 4:8]  # w, x, y, z
    else:
        gt_ts, gt_pos, gt_quat = np.zeros(0), np.zeros((0, 3)), np.zeros((0, 4))

    sensor_yaml = os.path.join(cam_dir, "sensor.yaml")
    return EurocData(
        image_ts=image_ts, image_paths=image_paths,
        imu_ts=imu[:, 0] * 1e-9, imu_gyro=imu[:, 1:4], imu_accel=imu[:, 4:7],
        gt_ts=gt_ts, gt_pos=gt_pos, gt_quat=gt_quat,
        camera=_load_camera(sensor_yaml), R_cam_imu=_load_cam_extrinsic(sensor_yaml))


# ------------------------------------------------------------ sensor.yaml
def _scalar(text: str):
    text = text.strip()
    if re.fullmatch(r"[-+]?\d+", text):
        return int(text)
    try:
        return float(text)
    except ValueError:
        return text.strip("'\"")


def _value(text: str):
    text = text.strip()
    if text.startswith("["):
        inner = text[1:text.rindex("]")].strip()
        return [_scalar(x) for x in inner.split(",")] if inner else []
    return _scalar(text)


def parse_sensor_yaml(text: str) -> dict:
    """The subset of YAML a EuRoC sensor.yaml uses: top-level `key: value`
    lines, flow lists `[a, b, ...]` that may run over several lines, and
    one level of indented `key: value` lines under a key with no value
    (T_BS's `cols` / `rows` / `data`). Comments start at '#'."""
    doc: dict = {}
    block = None
    pending = ""
    for raw in text.splitlines():
        line = raw.split("#", 1)[0].rstrip()
        if pending:
            pending += " " + line.strip()
        elif not line.strip():
            continue
        else:
            pending = line
        if pending.count("[") > pending.count("]"):
            continue  # a flow list runs on
        logical, pending = pending, ""
        key, sep, val = logical.strip().partition(":")
        if not sep:
            raise ValueError(f"sensor.yaml: cannot read line {raw!r}")
        if logical[0] in " \t" and block is not None:
            block[key.strip()] = _value(val)
        elif val.strip():
            doc[key.strip()] = _value(val)
            block = None
        else:
            block = doc[key.strip()] = {}
    return doc


def _read_sensor_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_sensor_yaml(f.read())


def _load_cam_extrinsic(sensor_yaml: str) -> np.ndarray:
    """Camera-from-body rotation from cam0's T_BS (sensor to body, 4x4
    row-major). Body == imu0 frame, so this maps gyro rotations into the
    camera frame."""
    if not os.path.exists(sensor_yaml):
        return np.eye(3)
    doc = _read_sensor_yaml(sensor_yaml)
    try:
        tbs = doc["T_BS"]
        data = np.asarray(tbs["data"] if isinstance(tbs, dict) else tbs,
                          np.float64).reshape(4, 4)
        return data[:3, :3].T  # R_SB = cam-from-body
    except (KeyError, TypeError, ValueError):
        return np.eye(3)


def _load_camera(sensor_yaml: str) -> CameraConfig:
    """cam0 intrinsics; the standard EuRoC values when absent
    (parity: EuRoCReader.cpp:12-20)."""
    defaults = CameraConfig()
    if not os.path.exists(sensor_yaml):
        return defaults
    doc = _read_sensor_yaml(sensor_yaml)
    try:
        fx, fy, cx, cy = doc["intrinsics"]
        dist = doc.get("distortion_coefficients", [0, 0, 0, 0])
        w, h = doc.get("resolution", [defaults.width, defaults.height])
        return CameraConfig(width=int(w), height=int(h), fx=float(fx), fy=float(fy),
                            cx=float(cx), cy=float(cy), k1=float(dist[0]), k2=float(dist[1]),
                            p1=float(dist[2]), p2=float(dist[3]))
    except (KeyError, TypeError, ValueError):
        return defaults


# ------------------------------------------------------------------- PNG
def _unfilter_flat(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Images whose rows use None, Sub and Up only: Sub is a running sum
    along the row and a run of Up rows a running sum down the columns
    from the row above the run, so the stack takes a fixed number of
    array operations. raw (n, H, W) uint8, ftype (n, H)."""
    n, h, _ = raw.shape
    x = raw
    if (ftype == 1).any():
        x = np.where((ftype == 1)[..., None], np.cumsum(raw, -1, dtype=np.uint8), raw)
    if not (ftype == 2).any():
        return x
    cs = np.zeros((n, h + 1) + raw.shape[2:], np.uint8)   # sums wrap mod 256
    np.cumsum(x, 1, dtype=np.uint8, out=cs[:, 1:])
    # the row each Up run stands on (0 for a run from the top)
    base = np.maximum.accumulate(np.where(ftype != 2, np.arange(h), 0), axis=1)
    return cs[:, 1:] - cs[np.arange(n)[:, None], base]


def _unfilter_walk(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Images with any row filters. Average and Paeth read the decoded
    left neighbour, so pixel (r, i) waits for (r, i-1), (r-1, i) and
    (r-1, i-1): the walk decodes one anti-diagonal a step, one vector over
    every row of every image, in a skewed layout S[t + 2, r + 1, k] =
    x[k, r, t - r] (zero rows for the steps before the first; zero above
    the top row), so it takes W + H - 1 steps whatever the stack's size.
    A step selects with -1 / 0 masks and sign bits rather than np.where,
    which costs several arithmetic operations at this size.
    raw (n, H, W) uint8, ftype (n, H)."""
    n, h, w = raw.shape
    steps = w + h - 1
    rows = np.arange(h)
    diag = rows + np.arange(w)[:, None]              # (W, H): the step of x[r, i]
    skew = np.zeros((steps + 2, h + 1, n), np.int16)
    raw_s = np.zeros((steps, h, n), np.int16)
    raw_s[diag, rows] = raw.transpose(2, 1, 0)
    sub, up, avg, paeth = (-(ftype.T == f).astype(np.int16) for f in (1, 2, 3, 4))
    for t in range(steps):
        lo, hi = max(0, t - w + 1), min(h, t + 1)    # the rows on this anti-diagonal
        a = skew[t + 1, lo + 1:hi + 1]               # x[r, i - 1]
        b = skew[t + 1, lo:hi]                       # x[r - 1, i]
        c = skew[t, lo:hi]                           # x[r - 1, i - 1]
        da, db = a - c, b - c
        pa, pb, pc = np.abs(db), np.abs(da), np.abs(da + db)
        pick_a = ~(((pb - pa) | (pc - pa)) >> 15)    # -1 where pa <= pb and pa <= pc
        pick_b = ~((pc - pb) >> 15)                  # -1 where pb <= pc
        pred = db & pick_b
        pred += (da - pred) & pick_a
        pred += c                                    # the Paeth predictor
        pred &= paeth[lo:hi]
        pred |= (a & sub[lo:hi]) | (b & up[lo:hi]) | (((a + b) >> 1) & avg[lo:hi])
        pred += raw_s[t, lo:hi]
        np.bitwise_and(pred, 255, out=skew[t + 2, lo + 1:hi + 1])
    return skew[diag + 2, rows + 1].transpose(2, 1, 0).astype(np.uint8)


def _unfilter_rows(raw: np.ndarray, ftype: np.ndarray) -> np.ndarray:
    """Undo the PNG row filters of a stack of 8-bit single-channel images.
    raw (n, H, W) uint8 filtered bytes, ftype (n, H) filter types 0-4.
    Images without Average or Paeth rows take the flat path, the others
    one walk together."""
    walk = (ftype >= 3).any(1)
    out = np.empty_like(raw)
    if not walk.all():
        out[~walk] = _unfilter_flat(raw[~walk], ftype[~walk])
    if walk.any():
        out[walk] = _unfilter_walk(raw[walk], ftype[walk])
    return out


def inflate_png(data: bytes) -> Tuple[np.ndarray, np.ndarray]:
    """An 8-bit greyscale, non-interlaced PNG's filtered rows -> (raw
    (H, W) uint8, filter types (H,)). Raises ValueError for anything else
    (another colour type or bit depth, a bad signature or checksum,
    truncated data)."""
    if data[:8] != PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, ihdr, idat = 8, None, []
    while True:
        if pos + 8 > len(data):
            raise ValueError("truncated PNG")
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("truncated PNG")
        if zlib.crc32(kind + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG chunk {kind!r} fails its checksum")
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if (depth, ctype, interlace) != (8, 0, 0):
        raise ValueError(f"unsupported PNG: bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} (8-bit greyscale, not interlaced, is read)")
    buf = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if buf.size != h * (w + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = buf.reshape(h, w + 1)
    if (rows[:, 0] > 4).any():
        raise ValueError("PNG row filter type out of range")
    return rows[:, 1:], rows[:, 0]


def decode_png_gray8(data: bytes) -> np.ndarray:
    """An 8-bit greyscale, non-interlaced PNG as (H, W) uint8; ValueError
    for anything else (see inflate_png)."""
    raw, ftype = inflate_png(data)
    return _unfilter_rows(raw[None], ftype[None])[0]


def _predictions(img: np.ndarray) -> np.ndarray:
    """The five PNG predictors (None, Sub, Up, Average, Paeth) of every
    pixel of a known (H, W) image -> (5, H, W) int16."""
    x = img.astype(np.int16)
    a = np.pad(x, ((0, 0), (1, 0)))[:, :-1]
    b = np.pad(x, ((1, 0), (0, 0)))[:-1]
    c = np.pad(b, ((0, 0), (1, 0)))[:, :-1]
    pa, pb, pc = np.abs(b - c), np.abs(a - c), np.abs(a + b - 2 * c)
    paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
    return np.stack([np.zeros_like(x), a, b, (a + b) >> 1, paeth])


def encode_png_gray8(img: np.ndarray, adaptive: bool = False) -> bytes:
    """(H, W) uint8 as an 8-bit greyscale PNG in one IDAT: every row
    filter 0, or with adaptive=True the filter of each row that libpng's
    default heuristic picks (the least sum of the residuals read as
    signed bytes), as writers of real datasets do."""
    img = np.ascontiguousarray(img, np.uint8)
    h, w = img.shape
    if adaptive:
        res = ((img.astype(np.int16) - _predictions(img)) & 255).astype(np.uint8)
        ftype = np.abs(res.view(np.int8).astype(np.int32)).sum(-1).argmin(0)
        body = res[ftype, np.arange(h)]
    else:
        ftype, body = np.zeros(h, np.int64), img

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))

    rows = np.concatenate([ftype.astype(np.uint8)[:, None], body], 1)
    return (PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + chunk(b"IEND", b""))


def load_image(path: str) -> np.ndarray:
    """Greyscale uint8 (H, W). uint8 on purpose: frames go to the device
    as they are and the front end casts them there."""
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    with open(path, "rb") as f:
        return decode_png_gray8(f.read())


def load_image_safe(path: str) -> Optional[np.ndarray]:
    """Like load_image, but None for a missing, corrupt or unreadable file:
    the reference reader skips unreadable images and continues
    (src/legacy/EuRoCReader.cpp:287-291)."""
    return load_images_safe([path])[0]


def load_images_safe(paths: List[str]) -> List[Optional[np.ndarray]]:
    """load_image_safe over several files: the row filters of all the
    readable images of one size are undone together, so a chunk of
    frames costs one walk (see _unfilter_rows)."""
    rows: List[Optional[Tuple[np.ndarray, np.ndarray]]] = []
    for path in paths:
        try:
            with open(path, "rb") as f:
                rows.append(inflate_png(f.read()))
        except (OSError, ValueError, zlib.error, struct.error):
            rows.append(None)
    out: List[Optional[np.ndarray]] = [None] * len(paths)
    for shape in {r[0].shape for r in rows if r is not None}:
        idx = [i for i, r in enumerate(rows) if r is not None and r[0].shape == shape]
        imgs = _unfilter_rows(np.stack([rows[i][0] for i in idx]),
                             np.stack([rows[i][1] for i in idx]))
        for i, img in zip(idx, imgs):
            out[i] = img
    return out


class DecodeProcesses:
    """load_images_safe split over `n` child Python processes that import
    only numpy and this module: each takes a share of the paths on its
    stdin and sends its images back on its stdout, pickled. The anti-
    diagonal walk is tens of thousands of small numpy calls a batch, so
    in a thread of a process whose main thread is busy its GIL hand-offs
    would slow that thread too; and a walk over a third of a batch takes
    about half the time of the whole. Use as a context manager; leaving
    it closes the children's stdin and waits for them to end."""

    def __init__(self, n: int):
        root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            p for p in (root, os.environ.get("PYTHONPATH")) if p))
        self._procs = [subprocess.Popen(
            [sys.executable, "-c", f"from {__name__} import _serve; _serve()"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, env=env) for _ in range(n)]

    def __call__(self, paths: List[str]) -> List[Optional[np.ndarray]]:
        shares = np.array_split(np.arange(len(paths)), len(self._procs))
        # every request is written before any answer is read: a request is
        # small, so no child waits on a full pipe for the parent to read
        for proc, share in zip(self._procs, shares):
            pickle.dump([paths[i] for i in share], proc.stdin, protocol=pickle.HIGHEST_PROTOCOL)
            proc.stdin.flush()
        out: List[Optional[np.ndarray]] = []
        for proc in self._procs:
            out += pickle.load(proc.stdout)  # EOFError if the child died
        return out

    def __enter__(self) -> "DecodeProcesses":
        return self

    def __exit__(self, *exc) -> None:
        # stdout closes before the wait: a child left writing an answer
        # nobody reads (a call that raised) ends on the broken pipe
        for proc in self._procs:
            proc.stdin.close()
            proc.stdout.close()
        for proc in self._procs:
            proc.wait()


def _serve() -> None:
    """A DecodeProcesses child's loop, until its stdin closes."""
    src, dst = sys.stdin.buffer, sys.stdout.buffer
    while True:
        try:
            paths = pickle.load(src)
        except EOFError:
            return
        pickle.dump(load_images_safe(paths), dst, protocol=pickle.HIGHEST_PROTOCOL)
        dst.flush()


def imu_window(data: EurocData, t_prev: float, t_now: float) -> Tuple[np.ndarray, ...]:
    """IMU samples with t in (t_prev, t_now] (parity: getNext,
    EuRoCReader.cpp:277-309)."""
    lo = np.searchsorted(data.imu_ts, t_prev, side="right")
    hi = np.searchsorted(data.imu_ts, t_now, side="right")
    return data.imu_ts[lo:hi], data.imu_accel[lo:hi], data.imu_gyro[lo:hi]


def interpolate_gt(data: EurocData, t: float) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """Ground-truth (pos, quat) at time t, linear / slerp (parity:
    getGroundTruth, EuRoCReader.cpp:311-346). None outside the range."""
    ts = data.gt_ts
    if len(ts) == 0 or t < ts[0] or t > ts[-1]:
        return None
    i = np.searchsorted(ts, t)
    if i == 0:
        return data.gt_pos[0], data.gt_quat[0]
    a = (t - ts[i - 1]) / max(ts[i] - ts[i - 1], 1e-12)
    pos = (1 - a) * data.gt_pos[i - 1] + a * data.gt_pos[i]
    q0, q1 = data.gt_quat[i - 1], data.gt_quat[i]
    dot = np.dot(q0, q1)
    q1 = q1 if dot >= 0 else -q1
    dot = abs(dot)
    if dot > 0.9995:
        q = (1 - a) * q0 + a * q1
    else:
        th = np.arccos(np.clip(dot, -1, 1))
        q = (np.sin((1 - a) * th) * q0 + np.sin(a * th) * q1) / np.sin(th)
    return pos, q / np.linalg.norm(q)
