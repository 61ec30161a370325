"""Aria glasses device port + mock (counterpart of the JAX package's
io/aria.py; host-only).

Parity: reference IAriaDevice (include/interfaces/IAriaDevice.hpp:39-73
— connect/startStreaming/callbacks for RGB + 2x SLAM cams + IMU +
calibration/spinOnce) and the H15 design's MockAriaDevice replaying
disk images at 33 ms intervals (SURVEY.md row 26). The real device
adapter needs the proprietary Aria SDK (out of scope in this image);
the port + mock give the pipeline a live-streaming surface today. The
mock reads PNGs with the port's own decoder (io/euroc.load_image), so it
replays *.png files only.
"""

from __future__ import annotations

import glob
import os
import threading
import time
from dataclasses import dataclass
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np

from aria_slam_tpu_torch.io.euroc import load_image


@dataclass
class AriaCalibration:
    """Per-camera pinhole approximation (the SDK exposes full Fisheye624;
    downstream SLAM consumes the pinhole part)."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int
    height: int


ImageCallback = Callable[[float, np.ndarray, str], None]  # (ts, image, camera_id)
ImuCallback = Callable[[float, np.ndarray, np.ndarray], None]  # (ts, accel, gyro)


@runtime_checkable
class AriaDevice(Protocol):
    """Port (parity: IAriaDevice)."""

    def connect(self) -> bool: ...
    def start_streaming(self) -> None: ...
    def stop_streaming(self) -> None: ...
    def set_image_callback(self, cb: ImageCallback) -> None: ...
    def set_imu_callback(self, cb: ImuCallback) -> None: ...
    def get_calibration(self, camera_id: str) -> Optional[AriaCalibration]: ...
    def spin_once(self, timeout_s: float = 0.1) -> None: ...


class MockAriaDevice:
    """Replays images from a directory at a fixed interval on a worker
    thread (parity: H15 MockAriaDevice, 33 ms default)."""

    def __init__(self, image_dir: str, interval_s: float = 0.033,
                 camera_id: str = "slam-left", imu_hz: float = 0.0):
        self._paths = sorted(glob.glob(os.path.join(image_dir, "*.png")))
        self._interval = interval_s
        self._camera_id = camera_id
        self._imu_hz = imu_hz
        self._img_cb: Optional[ImageCallback] = None
        self._imu_cb: Optional[ImuCallback] = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self.connected = False

    def connect(self) -> bool:
        self.connected = len(self._paths) > 0
        return self.connected

    def set_image_callback(self, cb: ImageCallback) -> None:
        self._img_cb = cb

    def set_imu_callback(self, cb: ImuCallback) -> None:
        self._imu_cb = cb

    def get_calibration(self, camera_id: str) -> Optional[AriaCalibration]:
        if not self._paths:
            return None
        h, w = load_image(self._paths[0]).shape
        f = 0.9 * w
        return AriaCalibration(fx=f, fy=f, cx=w / 2, cy=h / 2, width=w, height=h)

    def start_streaming(self) -> None:
        if not self.connected:
            raise RuntimeError("connect() first")
        self._stop.clear()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _loop(self) -> None:
        t0 = time.time()
        for k, path in enumerate(self._paths):
            if self._stop.is_set():
                return
            ts = t0 + k * self._interval
            if self._imu_cb and self._imu_hz > 0:
                n = max(1, int(self._interval * self._imu_hz))
                for j in range(n):
                    self._imu_cb(ts + j / self._imu_hz,
                                 np.array([0.0, 0.0, 9.81]), np.zeros(3))
            if self._img_cb:
                img = load_image(path).astype(np.float32)
                self._img_cb(ts, img, self._camera_id)
            sleep = ts + self._interval - time.time()
            if sleep > 0:
                time.sleep(sleep)

    def spin_once(self, timeout_s: float = 0.1) -> None:
        time.sleep(min(timeout_s, self._interval))

    def stop_streaming(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2.0)
            self._thread = None
