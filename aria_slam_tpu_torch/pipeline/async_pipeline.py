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
(drop_threshold), the reference's degradation policy. Every stage runs
on a native worker thread through a ctypes callback, so the card's work
of a frame is launched from the dispatch thread.

A stage that raises fails the run: ctypes would print the exception and
carry on, leaving the frame out of the results without an error. Each
stage keeps the first exception (with its stage and frame) and drops its
frame; drain() then raises it, and raises too when frames are still in
flight at its timeout. Each collected frame leaves its stage times and
its submit-to-collect latency in `timings`.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Optional

import numpy as np

from aria_slam_tpu_torch import native
from aria_slam_tpu_torch.io.euroc import decode_png_gray8
from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline


class StageError(RuntimeError):
    """A stage of the async pipeline raised; __cause__ is its exception."""


class AsyncSlamPipeline:
    """Submit frames (PNG bytes or arrays); read the results as they come
    (on_result(timestamp, pose)) or after drain()."""

    STAGES = ("decode", "dispatch", "collect")

    def __init__(self, pipe: SlamPipeline, drop_threshold: int = 4,
                 on_result: Optional[Callable] = None):
        self.pipe = pipe
        self.on_result = on_result
        self._items: dict = {}
        self._lock = threading.Lock()
        self._results: list = []
        # per collected frame: {"decode", "dispatch", "collect", "latency"} ms
        self.timings: list = []
        self.error: StageError | None = None
        self._exec = native.AsyncExecutor(
            [self._stage(n, getattr(self, "_" + n)) for n in self.STAGES],
            queue_capacity=8, drop_threshold=drop_threshold)
        self._next_id = 0

    def _stage(self, name: str, body: Callable):
        """The native executor's callback for one stage: body(item) timed;
        an exception recorded (the first) with its frame dropped."""
        last = name == self.STAGES[-1]

        def run(item_id: int):
            it = self._items.get(item_id)
            if it is None:  # dropped: an earlier stage raised on it
                return
            t0 = time.perf_counter()
            try:
                body(it)
            except BaseException as e:  # kept; drain raises it
                err = StageError(f"the {name} stage raised on the frame at "
                                 f"{it['timestamp']}: {e!r}")
                err.__cause__ = e
                with self._lock:
                    self.error = self.error or err
                self._items.pop(item_id, None)
                return
            t1 = time.perf_counter()
            it["ms"][name] = (t1 - t0) * 1e3
            if last:
                it["ms"]["latency"] = (t1 - it["submitted"]) * 1e3
                with self._lock:
                    self.timings.append(it["ms"])
                self._items.pop(item_id)

        return run

    # -- stages (called from the native worker threads)
    def _decode(self, it: dict):
        if "bytes" in it:
            it["image"] = decode_png_gray8(it.pop("bytes"))  # uint8: the device casts

    def _dispatch(self, it: dict):
        it["pose"] = self.pipe.process_frame(it["image"], it["timestamp"])

    def _collect(self, it: dict):
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
        it = {"timestamp": timestamp, "submitted": time.perf_counter(), "ms": {}}
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
        """Wait until every accepted frame is collected; the results.
        Raises StageError when a stage raised, TimeoutError when frames
        are still in flight after timeout_s."""
        deadline = time.monotonic() + timeout_s
        while self._items and self.error is None and time.monotonic() < deadline:
            time.sleep(0.005)
        if self.error is not None:
            raise self.error
        if self._items:
            raise TimeoutError(f"{len(self._items)} frames still in flight after "
                               f"{timeout_s} s")
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
