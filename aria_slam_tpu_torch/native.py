"""ctypes binding of the repository's native C++ host runtime (the port's
own counterpart of the JAX package's native/__init__.py).

The sources are the repository's `native/src/pipeline.cpp` (the staged
executor: one worker thread a stage, bounded lock-free SPSC queues,
frame-skip backpressure at the first stage) and `native/src/io.cpp`
(numeric CSV parsing, threaded file read-ahead, PLY / PCD writers). At
first use they are compiled with `g++` into one shared library in
`aria_slam_tpu_torch/_build/` (listed in .gitignore), named by a hash of
the sources and flags, so an edited source rebuilds. Nothing is written
under `native/`. A failed build raises: there is no pure-Python
stand-in (the numpy CSV reader and map writers beside their callers,
io/euroc.py and mapping/export.py, are the plain versions the tests
compare with).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np

NATIVE_DIR = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("src/pipeline.cpp", "src/io.cpp")
HEADERS = ("src/spsc_queue.hpp",)
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-pthread", "-Wall", "-Wextra", "-shared")

STAGE_FN = ctypes.CFUNCTYPE(None, ctypes.c_uint64, ctypes.c_void_p)

_lock = threading.Lock()
_lib = None


class BuildError(RuntimeError):
    pass


def _target() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for rel in SOURCES + HEADERS:
        h.update((NATIVE_DIR / rel).read_bytes())
    return BUILD_DIR / f"libariaslam_native_{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE_DIR / s) for s in SOURCES)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise BuildError(f"g++ could not build the native runtime: {e}") from e
    if proc.returncode != 0:
        raise BuildError(f"g++ failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, target)


def _load() -> ctypes.CDLL:
    """The library, built on first use (raises BuildError)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        target = _target()
        if not target.exists():
            _build(target)
        lib = ctypes.CDLL(str(target))
        P, I, U64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint64
        sigs = {
            "pipeline_create": (P, [I, ctypes.POINTER(I), I]),
            "pipeline_set_stage": (None, [P, I, STAGE_FN, P]),
            "pipeline_start": (None, [P]),
            "pipeline_submit": (I, [P, U64]),
            "pipeline_stop": (None, [P]),
            "pipeline_stats": (None, [P] + [ctypes.POINTER(U64)] * 3),
            "pipeline_destroy": (None, [P]),
            "csv_parse_numeric": (ctypes.c_int64, [ctypes.c_char_p, I,
                                                   ctypes.POINTER(ctypes.c_double),
                                                   ctypes.c_int64]),
            "csv_count_rows": (ctypes.c_int64, [ctypes.c_char_p]),
            "ply_write": (ctypes.c_int64, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]),
            "pcd_write": (ctypes.c_int64, [ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
                                           ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64]),
            "preloader_create": (P, [ctypes.POINTER(ctypes.c_char_p), I]),
            "preloader_poll": (ctypes.c_int64, [P, I]),
            "preloader_take": (None, [P, I, ctypes.POINTER(ctypes.c_char)]),
            "preloader_destroy": (None, [P]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _lib = lib
        return lib


def available() -> bool:
    """Whether the native library builds (at first use) and loads here.
    Every other entry point raises when it cannot."""
    try:
        _load()
    except (BuildError, OSError):
        return False
    return True


# --------------------------------------------------------------------- CSV
def parse_csv(path: str, num_cols: int) -> np.ndarray:
    """The rows of a CSV file ('#' lines skipped) that hold num_cols
    leading numbers, as an (N, num_cols) float64 array; other fields
    after them are ignored."""
    lib = _load()
    n = lib.csv_count_rows(path.encode())
    if n < 0:
        raise FileNotFoundError(path)
    out = np.empty((n, num_cols), np.float64)
    got = lib.csv_parse_numeric(path.encode(), num_cols,
                                out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), n)
    return out[:got]


# ------------------------------------------------------------------- export
def _write(fn, path: str, xyz: np.ndarray, rgb: np.ndarray) -> int:
    xyz = np.ascontiguousarray(xyz, np.float32).reshape(-1, 3)
    rgb = np.ascontiguousarray(rgb, np.uint8).reshape(-1, 3)
    if len(xyz) != len(rgb):
        raise ValueError(f"{len(xyz)} points against {len(rgb)} colours")
    n = int(fn(path.encode(), xyz.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
               rgb.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(xyz)))
    if n < 0:
        raise OSError(f"cannot write {path}")
    return n


def write_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> int:
    """ASCII PLY of (N, 3) float32 points with (N, 3) uint8 colours; N."""
    return _write(_load().ply_write, path, xyz, rgb)


def write_pcd(path: str, xyz: np.ndarray, rgb: np.ndarray) -> int:
    """ASCII PCD with packed-float RGB; N."""
    return _write(_load().pcd_write, path, xyz, rgb)


# ----------------------------------------------------------------- executor
class AsyncExecutor:
    """The native staged pipeline. stages: callables fn(item_id: int),
    each run on its own worker thread in submission order; items are
    integer ids whose payloads the caller keeps. drop_threshold > 0
    drops a submission when the first stage's queue is that deep."""

    def __init__(self, stages, queue_capacity=8, drop_threshold=0):
        lib = _load()
        self._lib = lib
        n = len(stages)
        caps = (ctypes.c_int * n)(*([queue_capacity] * n))
        self._p = lib.pipeline_create(n, caps, drop_threshold)
        self._cbs = []  # the callbacks must outlive the native threads
        for i, fn in enumerate(stages):
            cb = STAGE_FN(lambda item, _u, f=fn: f(int(item)))
            self._cbs.append(cb)
            lib.pipeline_set_stage(self._p, i, cb, None)
        self._n = n
        lib.pipeline_start(self._p)
        self._stopped = False

    def submit(self, item_id: int) -> bool:
        """False when backpressure dropped the item."""
        return bool(self._lib.pipeline_submit(self._p, item_id))

    def stats(self) -> dict:
        proc = (ctypes.c_uint64 * self._n)()
        drop = (ctypes.c_uint64 * self._n)()
        depth = (ctypes.c_uint64 * self._n)()
        self._lib.pipeline_stats(self._p, proc, drop, depth)
        return {"processed": list(proc), "dropped": list(drop), "queue_depths": list(depth)}

    def stop(self) -> None:
        """Drain every queue and join the workers."""
        if not self._stopped:
            self._lib.pipeline_stop(self._p)
            self._stopped = True

    def close(self) -> None:
        if self._p is not None:
            self.stop()
            self._lib.pipeline_destroy(self._p)
            self._p = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class Preloader:
    """Threaded read-ahead of whole files (the decode stays in Python)."""

    def __init__(self, paths):
        lib = _load()
        self._lib = lib
        self._paths = (ctypes.c_char_p * len(paths))(*[os.fsencode(p) for p in paths])
        self._p = lib.preloader_create(self._paths, len(paths))
        self._n = len(paths)

    def get(self, idx: int, timeout_s: float = 10.0) -> bytes:
        if not 0 <= idx < self._n:
            raise IndexError(idx)
        t0 = time.monotonic()
        while True:
            size = self._lib.preloader_poll(self._p, idx)
            if size >= 0:
                buf = ctypes.create_string_buffer(int(size))
                self._lib.preloader_take(self._p, idx, buf)
                return buf.raw
            if size == -1:
                raise FileNotFoundError(f"preload failed for index {idx}")
            if time.monotonic() - t0 > timeout_s:
                raise TimeoutError(f"preload timeout for index {idx}")
            time.sleep(0.0005)

    def close(self) -> None:
        if self._p:
            self._lib.preloader_destroy(self._p)
            self._p = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
