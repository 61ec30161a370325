#!/usr/bin/env python3
"""Where the corner, match and patch kernels spend their time, on the card.

Run from the repository root on a machine with one NVIDIA H100:

    python3 tools/kernel_phases.py [--out phases.json]

The card's profilers are not available there, so this builds copies of
csrc/corner_kernel.cu, csrc/match_kernel.cu and csrc/patch_kernel.cu with
parts cut out and times each copy at the shapes `chip_smoke.py` uses (CUDA
graph replay, launch cost excluded):

- corner: copies that write -3e38 and stop before each phase (compass
  test, full FAST score, NMS, Harris), at B = 1 and B = 33 frames of the
  752x480 8-level pyramid;
- match: copies without the tensor-core products and/or without the
  top-2 updates, or without staging the train tiles after the first, at
  N = 1, 4 and 256 pairs of 2000x2000 descriptors;
- patch: copies without the staging copies into shared memory and/or
  without the float4 stores, and one that stages through registers
  (`__ldg`) instead of `cp.async`, at B = 1 and B = 33 frames of the
  detector's 2000 keypoints on the 8-level pyramid.

Every copy but the full kernels and the patch kernel's register-staged
copy computes wrong results; only the times mean something. The cuts are
text replacements of marked lines of the sources; the script stops if a
marker is missing.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from aria_slam_tpu_torch.ops.cuda import _lib  # noqa: E402

CORNER_STOP = """  for (int i = tid; i < TH * TW; i += NT) {
    const int gy = y0 + i / TW, gx = x0 + i % TW;
    if (gy < H && gx < W) dst[(size_t)gy * W + gx] = NEG_INF;
  }
  return;
"""
# cumulative: each copy stops before the marked phase (a copy that stops
# before the compass test loses the staging too, as dead code)
CORNER_PHASES = {"-3e38 writes only": "  // 2. compass test",
                 "+ staging, compass test": "  // 3. full FAST",
                 "+ full FAST": "  // 4. NMS", "+ NMS": "  // 5. -3e38"}
MATCH_PUSH = """  s.second = min(s.second, max(s.best, key));
  s.best = min(s.best, key);"""
MATCH_MMA = """  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));"""
MATCH_STAGE = "      stage(it + 1, buf ^ 1);"
PATCH_STAGE = "      cp_async4(&s_patch[lead + e], src + (size_t)y * W + x);\n"
PATCH_STORE = "  for (int q = tid; q < body; q += NT) d4[q] = s4[q];\n"
NO_PUSH = "  s.best ^= key;"
NO_MMA = "  c[0] ^= a[0] ^ b0; c[1] ^= a[1] ^ b1; c[2] ^= a[2]; c[3] ^= a[3];"


def variants() -> dict:
    """{(library, variant): source}."""
    corner = (_lib.CSRC_DIR / "corner_kernel.cu").read_text()
    match = (_lib.CSRC_DIR / "match_kernel.cu").read_text()
    patch = (_lib.CSRC_DIR / "patch_kernel.cu").read_text()
    for marker in [*CORNER_PHASES.values()]:
        if marker not in corner:
            raise SystemExit(f"marker {marker!r} not in corner_kernel.cu")
    for marker in (MATCH_PUSH, MATCH_MMA, MATCH_STAGE):
        if marker not in match:
            raise SystemExit(f"marker not in match_kernel.cu:\n{marker}")
    for marker in (PATCH_STAGE, PATCH_STORE):
        if marker not in patch:
            raise SystemExit(f"marker not in patch_kernel.cu:\n{marker}")
    out = {("corner", name): corner.replace(marker, CORNER_STOP + marker)
           for name, marker in CORNER_PHASES.items()}
    out[("corner", "+ Harris (full kernel)")] = corner
    out[("match", "full kernel")] = match
    out[("match", "no top-2 updates")] = match.replace(MATCH_PUSH, NO_PUSH)
    out[("match", "no MMA")] = match.replace(MATCH_MMA, NO_MMA)
    out[("match", "no MMA, no top-2 updates")] = match.replace(MATCH_MMA, NO_MMA).replace(
        MATCH_PUSH, NO_PUSH)
    # every tile after the first computes on whatever its buffer holds
    out[("match", "no train staging")] = match.replace(MATCH_STAGE, "      cp_async_commit();")
    # the stores then write whatever shared memory holds; the staging loop,
    # left with no effect, goes as dead code
    out[("patch", "full kernel")] = patch
    out[("patch", "no staging")] = patch.replace(PATCH_STAGE, "")
    out[("patch", "no float4 stores")] = patch.replace(PATCH_STORE, "")
    out[("patch", "no staging, no float4 stores")] = patch.replace(PATCH_STAGE, "").replace(
        PATCH_STORE, "")
    # the same function, staged through registers instead of cp.async
    out[("patch", "loads through registers")] = patch.replace(
        PATCH_STAGE, "      s_patch[lead + e] = __ldg(src + (size_t)y * W + x);\n")
    return out


def build(sources: dict, tmp: Path) -> dict:
    """Compile every copy in parallel into `tmp`; {key: (library path,
    ptxas lines)}."""
    tmp.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, (key, src) in enumerate(sources.items()):
        cu, so = tmp / f"v{i}.cu", tmp / f"v{i}.so"
        cu.write_text(src)
        procs[key] = (so, subprocess.Popen([_lib._nvcc(), *_lib.NVCC_FLAGS, "-o", str(so),
                                            str(cu)], stdout=subprocess.PIPE,
                                           stderr=subprocess.STDOUT, text=True))
    out = {}
    for key, (so, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for {key}:\n{log}")
        out[key] = (so, cs.ptxas_lines(log))
    return out


def use(lib_name: str, path: Path) -> None:
    """Make the wrappers launch the copy at `path` (set before every use,
    so that `_lib.library` never loads the real libraries over it)."""
    lib = ctypes.CDLL(str(path))
    for fn, argtypes in _lib.SOURCES[lib_name][1].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    _lib._STATE.libs[lib_name] = lib


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the times to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_phases: CUDA is not available; this script runs on the card only",
              file=sys.stderr)
        return 1
    from aria_slam_tpu_torch.config import CameraConfig, OrbConfig
    from aria_slam_tpu_torch.ops.cuda import corner_kernel as ck
    from aria_slam_tpu_torch.ops.cuda import match_kernel as mk
    from aria_slam_tpu_torch.ops.brief import PATCH_R
    from aria_slam_tpu_torch.ops.cuda import patch_kernel as pk

    smi = cs.smi_line()
    print(f"device times (CUDA graph replay) on {smi}", flush=True)
    dev = torch.device("cuda")
    cfg = OrbConfig()
    frames, _, _ = cs.render_frames(CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0), 33, cs.FPS)
    levels = {b: cs.pyramid_levels(frames[:b], cfg, dev) for b in (1, 33)}
    gen = torch.Generator(device=dev).manual_seed(1)
    pairs = {n: (torch.randint(0, 2, (n, 2000, 256), generator=gen, device=dev,
                               dtype=torch.int8),
                 torch.randint(0, 2, (n, 2000, 256), generator=gen, device=dev,
                               dtype=torch.int8),
                 torch.rand((n, 2000), generator=gen, device=dev) >= 0.1)
             for n in (1, 4, 256)}
    patches = {}
    for b in (1, 33):
        inputs = cs.level_inputs(frames[:b], cfg, dev)
        patches[b] = ([img for _, img, _ in inputs], [xy for _, _, xy in inputs])
    rows = []
    tmp = _lib.BUILD_DIR / "phases"
    for (lib_name, name), (path, ptxas) in build(variants(), tmp).items():
        use(lib_name, path)
        if lib_name == "corner":
            times = {f"B{b}": cs.graph_ms(lambda: ck.corner_rank_maps(
                lv, cfg.fast_threshold, cfg.harris_block_size)) for b, lv in levels.items()}
        elif lib_name == "patch":
            times = {f"B{b}": cs.graph_ms(lambda: pk.extract_patches_levels(*p, PATCH_R),
                                          iters=5 if b > 1 else 20,
                                          replays=4 if b > 1 else 10)
                     for b, p in patches.items()}
        else:
            times = {f"N{n}": cs.graph_ms(lambda: mk.match_top2_batched(*p),
                                          iters=5 if n > 16 else 20,
                                          replays=4 if n > 16 else 10)
                     for n, p in pairs.items()}
        rows.append(dict(kernel=lib_name, variant=name, ms=times, ptxas=ptxas))
        print(f"{lib_name:6s} {name:30s} " + "  ".join(f"{k} {v:.4f} ms"
                                                       for k, v in times.items()), flush=True)
    shutil.rmtree(tmp)
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, "rows": rows}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
