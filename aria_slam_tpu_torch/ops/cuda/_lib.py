"""Build, load and launch helpers for the hand-written CUDA kernels.

Each source under `aria_slam_tpu_torch/csrc/` is compiled by `nvcc` for
`sm_90a` into its own shared library with a plain C interface, at first
use, into `aria_slam_tpu_torch/_build/` (listed in .gitignore). All
sources compile in parallel, one `nvcc` each. A library's file name
carries a hash of its source and flags, so an edited source rebuilds.
Every C entry point launches on the stream it is given and returns
`cudaGetLastError()`; `check` raises on a non-zero code.

Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# --fmad=false: no multiply-add contraction, so every float operation
# rounds exactly where the plain PyTorch version's separate ops round
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# library name -> (source file, {C function: argument types})
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SOURCES = {
    "corner": ("corner_kernel.cu",
               {"corner_rank_map_launch": (_P, _P, _I, _I, _I, _F, _F, _I, _P)}),
    "patch": ("patch_kernel.cu",
              {"extract_patches_launch": (_P, _P, _P, _I, _I, _I, _I, _I, _P)}),
    "match": ("match_kernel.cu",
              {"match_top2_launch": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P)}),
}


class BuildError(RuntimeError):
    pass


class _Libraries:
    """The loaded libraries plus what the build reported."""

    def __init__(self):
        self.libs: dict = {}
        self.build_log = ""
        self.build_seconds = 0.0


_STATE = _Libraries()


def _nvcc() -> str:
    cands = [os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
             shutil.which("nvcc") or ""]
    for c in cands:
        if c and os.path.isfile(c):
            return c
    raise BuildError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _target(name: str) -> Path:
    src = (CSRC_DIR / SOURCES[name][0]).read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{digest}.so"


def build_all() -> dict:
    """Compile every source that has no up-to-date library, all `nvcc`
    processes started together. Returns {name: library path}."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    targets = {name: _target(name) for name in SOURCES}
    todo = {n: t for n, t in targets.items() if not t.exists()}
    t0 = time.perf_counter()
    procs = {}
    try:
        for name, target in todo.items():
            tmp = target.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / SOURCES[name][0])]
            procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.STDOUT, text=True), tmp)
        logs, failed = [], []
        for name, (proc, tmp) in procs.items():
            out, _ = proc.communicate()
            logs.append(f"[{name}] {out.strip()}")
            if proc.returncode != 0:
                failed.append(name)
            else:
                os.replace(tmp, todo[name])
    finally:
        for proc, _ in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    _STATE.build_seconds = time.perf_counter() - t0
    _STATE.build_log = "\n".join(logs)
    if failed:
        raise BuildError(f"nvcc failed for {failed}:\n{_STATE.build_log}")
    return targets


def build_report() -> tuple:
    """(seconds, nvcc output incl. -Xptxas -v) of this process's build."""
    return _STATE.build_seconds, _STATE.build_log


def library(name: str) -> ctypes.CDLL:
    """The loaded library `name`, building every source on first use."""
    if name not in _STATE.libs:
        paths = build_all()
        for lib_name, path in paths.items():
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SOURCES[lib_name][1].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            _STATE.libs[lib_name] = lib
    return _STATE.libs[name]


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_launch(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {code}")


def require_cuda(t: torch.Tensor, name: str, dtype: torch.dtype,
                 shape: tuple) -> None:
    """Validate a kernel argument: device, dtype, shape (None = any
    extent) and contiguity."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(s is not None and s != d
                                    for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
