"""Scene-understanding (VLM) hook (counterpart of the JAX package's
models/vlm.py; host-only).

Parity: the reference's H25 design runs an out-of-process Python VLM
companion over ROS2 so scene-description latency never blocks SLAM
(SURVEY.md row 28, external `aria-scene` repo). Here the same
decoupling is a port + an async runner: the SLAM loop submits frames
with a drop-oldest policy and consumes descriptions whenever they are
ready. A heuristic mock (detection-summary -> text) stands in for a
real VLM; any callable `describe(image, detections) -> str` plugs in.
Detections are the port's (torch tensors, on the card or the CPU).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Optional, Protocol, runtime_checkable

import numpy as np
import torch


@dataclass
class SceneDescription:
    timestamp: float
    text: str
    latency_s: float


@runtime_checkable
class SceneUnderstanding(Protocol):
    def describe(self, image: np.ndarray, detections=None) -> str: ...


class MockSceneUnderstanding:
    """Detection-summary heuristic (fast path stand-in for FastViT/FastVLM)."""

    def describe(self, image: np.ndarray, detections=None) -> str:
        bright = float(image.float().mean() if isinstance(image, torch.Tensor)
                       else np.mean(image))
        light = "bright" if bright > 140 else ("dim" if bright < 70 else "indoor")
        n = 0
        if detections is not None:
            n = int(detections.valid.sum())  # one host read for a tensor
        objs = f"{n} objects detected" if n else "no objects detected"
        return f"{light} scene, {objs}"


class AsyncSceneWorker:
    """Non-blocking runner: submit() never waits; latest description wins.

    Mirrors the H25 hybrid-router intent: the SLAM loop stays real-time
    regardless of VLM latency.
    """

    def __init__(self, model: SceneUnderstanding, clock=None):
        import time

        self.model = model
        self._clock = clock or time.monotonic
        self._in: queue.Queue = queue.Queue(maxsize=1)
        self._latest: Optional[SceneDescription] = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, timestamp: float, image: np.ndarray, detections=None) -> bool:
        """Drop-oldest: replaces any queued frame. Returns False if the
        previous frame was discarded."""
        kept = True
        try:
            self._in.put_nowait((timestamp, image, detections))
        except queue.Full:
            try:
                self._in.get_nowait()
                kept = False
            except queue.Empty:
                pass
            self._in.put_nowait((timestamp, image, detections))
        return kept

    def latest(self) -> Optional[SceneDescription]:
        with self._lock:
            return self._latest

    def _loop(self):
        while not self._stop.is_set():
            try:
                ts, img, det = self._in.get(timeout=0.1)
            except queue.Empty:
                continue
            t0 = self._clock()
            text = self.model.describe(img, det)
            desc = SceneDescription(ts, text, self._clock() - t0)
            with self._lock:
                self._latest = desc

    def close(self):
        self._stop.set()
        self._thread.join(timeout=2.0)
