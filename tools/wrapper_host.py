#!/usr/bin/env python3
"""Where the patch wrapper's host time goes, on the card's machine.

Run from the repository root on a machine with one NVIDIA H100:

    python3 tools/wrapper_host.py [--out host.json]

`extract_patches_levels` at B = 1 on the detector's 2000 keypoints of one
752x480 frame of `chip_smoke.py`'s scene: host microseconds (the best of
5 repeats of 2000 calls, `timeit`) of its 17 tensor checks, of three ways
to fill its level table (element by element as the corner wrapper fills
its own, one slice a field as the patch wrapper does, one `struct.pack`
of the whole structure), and of the whole call; and the call with launch
cost (`chip_smoke.cuda_ms`: the median of 5 repeats of CUDA events around
50 calls). The three tables
must hold the same bytes.
"""

from __future__ import annotations

import argparse
import json
import struct
import sys
import timeit
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from aria_slam_tpu_torch.ops.cuda import _lib  # noqa: E402
from aria_slam_tpu_torch.ops.cuda import patch_kernel as pk  # noqa: E402

M = _lib.MAX_LEVELS
PACK_FORMAT = f"={M}Q{M}Q{M}i{M}i{M}i{M + 1}i{M + 1}ii4x"  # _lib.PatchLevels, 8-byte end pad


def host_us(fn, number: int = 2000) -> float:
    return min(timeit.repeat(fn, number=number, repeat=5)) / number * 1e6


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", help="also write the times to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("wrapper_host: CUDA is not available", file=sys.stderr)
        return 1
    from aria_slam_tpu_torch.config import CameraConfig, OrbConfig

    dev = torch.device("cuda")
    frames, _, _ = cs.render_frames(CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0), 1, cs.FPS)
    inputs = cs.level_inputs(frames, OrbConfig(), dev)
    levels = [img for _, img, _ in inputs]
    xys = [xy for _, _, xy in inputs]
    n, radius = len(levels), 19
    imgs, ptrs = [t.data_ptr() for t in levels], [t.data_ptr() for t in xys]
    hs, ws = [t.shape[1] for t in levels], [t.shape[2] for t in levels]
    ks = [t.shape[1] for t in xys]
    first_key, first_block = pk.level_plan(ks)

    def checks():
        _lib.require_cuda(levels[0], "levels[0]", torch.float32, (None, None, None))
        for img, xy in zip(levels, xys):
            _lib.require_cuda(img, "img", torch.float32, (1, None, None))
            _lib.require_cuda(xy, "xy", torch.float32, (1, None, 2))

    def by_element():
        t = _lib.PatchLevels(num_levels=n)
        for i in range(n):
            t.img[i], t.xy[i] = imgs[i], ptrs[i]
            t.height[i], t.width[i], t.keys[i] = hs[i], ws[i], ks[i]
        for i in range(n + 1):
            t.first_key[i], t.first_block[i] = first_key[i], first_block[i]
        return t

    def by_field():
        t = _lib.PatchLevels(num_levels=n)
        t.img[:n], t.xy[:n] = imgs, ptrs
        t.height[:n], t.width[:n], t.keys[:n] = hs, ws, ks
        t.first_key[:n + 1], t.first_block[:n + 1] = first_key, first_block
        return t

    def by_pack():
        pad = [0] * (M - n)
        return _lib.PatchLevels.from_buffer_copy(struct.pack(
            PACK_FORMAT, *imgs, *pad, *ptrs, *pad, *hs, *pad, *ws, *pad, *ks, *pad,
            *first_key, *pad, *first_block, *pad, n))

    if not bytes(by_element()) == bytes(by_field()) == bytes(by_pack()):
        raise AssertionError("the three level tables differ")
    call = lambda: pk.extract_patches_levels(levels, xys, radius)  # noqa: E731
    call()
    torch.cuda.synchronize()
    rec = {"checks_us": host_us(checks), "table_by_element_us": host_us(by_element),
           "table_by_field_us": host_us(by_field), "table_by_pack_us": host_us(by_pack)}
    rec["call_host_us"] = host_us(call, number=500)
    torch.cuda.synchronize()
    rec["call_with_launch_ms"] = cs.cuda_ms(call, iters=50)
    smi = cs.smi_line()
    print(f"[wrapper_host] {smi}: " + ", ".join(f"{k} {v:.4f}" for k, v in rec.items()))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"nvidia_smi": smi, **rec}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
