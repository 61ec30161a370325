"""Async staged SLAM pipeline on the native executor (counterpart of the
JAX package's pipeline/async_pipeline.py).

Parity: the reference's H13 multithreaded pipeline (tracking, loop
closure and mapping threads joined by lock-free SPSC queues, frame-skip
backpressure). The card's work is enqueued by the frame step, so the
host stages are

    stage 0 (decode):   PNG bytes -> uint8 grey image (io/euroc.py's
                        decoder; the card's machine has no OpenCV)
    stage 1 (dispatch): SlamPipeline.process_frame
    stage 2 (collect):  results and the on_result callback

joined by the native queues (aria_slam_tpu_torch/native.py), with
submissions dropped at stage 0 when the device falls behind
(drop_threshold), the reference's degradation policy.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from aria_slam_tpu_torch import native
from aria_slam_tpu_torch.io.euroc import decode_png_gray8
from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline


class AsyncSlamPipeline:
    """Submit frames (PNG bytes or arrays); read the results as they come
    (on_result(timestamp, pose)) or after drain()."""

    def __init__(self, pipe: SlamPipeline, drop_threshold: int = 4,
                 on_result: Optional[Callable] = None):
        self.pipe = pipe
        self.on_result = on_result
        self._items: dict = {}
        self._lock = threading.Lock()
        self._results: list = []
        self._exec = native.AsyncExecutor(
            [self._decode, self._dispatch, self._collect],
            queue_capacity=8, drop_threshold=drop_threshold)
        self._next_id = 0

    # -- stages (called from the native worker threads)
    def _decode(self, item_id: int):
        it = self._items[item_id]
        if "bytes" in it:
            it["image"] = decode_png_gray8(it.pop("bytes"))  # uint8: the device casts

    def _dispatch(self, item_id: int):
        it = self._items[item_id]
        it["pose"] = self.pipe.process_frame(it["image"], it["timestamp"])

    def _collect(self, item_id: int):
        it = self._items.pop(item_id)
        with self._lock:
            self._results.append((it["timestamp"], it["pose"]))
        if self.on_result is not None:
            self.on_result(it["timestamp"], it["pose"])

    # -- API
    def submit(self, timestamp: float, image: np.ndarray | None = None,
               raw_bytes: bytes | None = None) -> bool:
        """False when backpressure dropped the frame."""
        item_id = self._next_id
        self._next_id += 1
        it = {"timestamp": timestamp}
        if image is not None:
            it["image"] = np.asarray(image)
        else:
            it["bytes"] = raw_bytes
        self._items[item_id] = it
        accepted = self._exec.submit(item_id)
        if not accepted:
            self._items.pop(item_id, None)
        return accepted

    def drain(self, timeout_s: float = 30.0):
        """Wait until every accepted frame is processed; the results."""
        deadline = time.monotonic() + timeout_s
        while self._items and time.monotonic() < deadline:
            time.sleep(0.005)
        return self.results

    @property
    def results(self):
        with self._lock:
            return list(self._results)

    def stats(self):
        return self._exec.stats()

    def close(self):
        self._exec.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
