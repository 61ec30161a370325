"""Structured logging (counterpart of the JAX package's utils/logging.py;
the reference prints bare std::cout lines with no levels)."""

from __future__ import annotations

import json
import logging
import sys
import time

_FMT = "%(asctime)s %(levelname)-7s %(name)s: %(message)s"


def get_logger(name: str = "aria_slam_tpu_torch", level: int = logging.INFO) -> logging.Logger:
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(_FMT))
        logger.addHandler(h)
        logger.setLevel(level)
        logger.propagate = False
    return logger


class MetricsEmitter:
    """JSONL metrics sink (per-frame stats, final summaries)."""

    def __init__(self, path: str | None = None):
        self._f = open(path, "a") if path else None

    def emit(self, event: str, **fields):
        rec = {"t": time.time(), "event": event, **fields}
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
            self._f.flush()
        return rec

    def close(self):
        if self._f:
            self._f.close()
            self._f = None
