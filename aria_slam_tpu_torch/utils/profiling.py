"""Per-stage timing (counterpart of the JAX package's utils/profiling.py
StageTimer).

Host wall clock around a named stage. On a CUDA device the stage ends
with torch.cuda.synchronize(), so the device work a stage launched is
charged to that stage and not to whichever later stage first waits for
it. The first event of every stage is kept apart as `warm_ms` (kernel
builds, allocator growth, library initialisation) and excluded from the
steady statistics.
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from typing import Dict, Iterator

import numpy as np
import torch


class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough for per-chunk
    use. `mean_ms`/`p50_ms`/`p95_ms`/`total_ms` describe the events after
    the first; a stage observed once reports its single event as both
    warm_ms and the steady statistics."""

    def __init__(self, window: int = 200, device=None):
        self.window = window
        device = None if device is None else torch.device(device)
        self._sync = device is not None and device.type == "cuda"
        self.samples: Dict[str, list] = defaultdict(list)
        self.first_ms: Dict[str, float] = {}
        # full-run steady accumulators (the window only bounds the
        # percentile buffers)
        self.total_s: Dict[str, float] = defaultdict(float)
        self.count: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self._sync:
                torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            if name not in self.first_ms:
                self.first_ms[name] = dt * 1000.0
            else:
                self.total_s[name] += dt
                self.count[name] += 1
                buf = self.samples[name]
                buf.append(dt)
                if len(buf) > self.window:
                    del buf[: len(buf) - self.window]

    def summary(self) -> Dict[str, Dict[str, float]]:
        out = {}
        for name, warm in self.first_ms.items():
            buf = self.samples[name]
            if buf:
                arr = np.asarray(buf) * 1000.0
                steady = {
                    "mean_ms": float(self.total_s[name] * 1000.0 / self.count[name]),
                    "p50_ms": float(np.percentile(arr, 50)),
                    "p95_ms": float(np.percentile(arr, 95)),
                    "total_ms": float(self.total_s[name] * 1000.0),
                    "count": self.count[name] + 1,
                }
            else:  # observed once: the warm event is the only data
                steady = {"mean_ms": warm, "p50_ms": warm, "p95_ms": warm,
                          "total_ms": warm, "count": 1}
            steady["warm_ms"] = warm
            out[name] = steady
        return out

    def warm_total_ms(self) -> float:
        """Sum of every stage's first event."""
        return float(sum(self.first_ms.values()))

    def report(self) -> str:
        lines = []
        for name, s in sorted(self.summary().items()):
            lines.append(
                f"{name:>20s}: mean {s['mean_ms']:7.2f} ms  "
                f"p50 {s['p50_ms']:7.2f}  p95 {s['p95_ms']:7.2f}  "
                f"warm {s['warm_ms']:8.1f}  (n={s['count']})"
            )
        return "\n".join(lines)
