"""Helpers of the per-layer metric readers (slam_bench/metrics/*.py).

A reader gets the traced run's context: `spans` ({name: [seconds]} on
the host clock), `device` (the trace's busy_s, window_s, launches,
kernels {name: seconds}, counts {name: launches}), `frames` and `units`
(sequence-frames and units: sequences or rounds in the window) and `info` (shapes
and per-launch least times the driver worked out from the window's
data). A reader that finds nothing to read returns None.
"""

from __future__ import annotations

import numpy as np

from slam_bench import counts

# the CUDA kernels of the port, by the function names in their sources
KERNELS = {"corner": ("corner_rank_maps_kernel",),
           "patch": ("extract_patches_kernel",),
           "match": ("match_top2_kernel", "merge_slices_kernel")}


def per_unit_ms(ctx, *names, per=None):
    """Summed spans of `names` a unit of the window, in ms; with `per`, a
    span of that name instead (the chunks of the sequences)."""
    spans = ctx["spans"]
    units = len(spans.get(per, ())) if per else ctx["units"]
    if not any(n in spans for n in names) or not units:
        return None
    return 1e3 * sum(sum(spans.get(n, ())) for n in names) / units


def mean_ms(ctx, name):
    v = ctx["spans"].get(name)
    return 1e3 * float(np.mean(v)) if v else None


def kernel(ctx, which):
    """(device seconds, launches) of one of the port's kernels."""
    dev = ctx["device"]
    t = sum(s for n, s in dev["kernels"].items() if any(k in n for k in KERNELS[which]))
    first = KERNELS[which][0]
    n = sum(c for name, c in dev["counts"].items() if first in name)
    return t, n


def least_s(ctx, which):
    """The least seconds of all of `which`'s launches in the window, or
    None where the driver could not work them out."""
    t, n = kernel(ctx, which)
    info = ctx["info"]
    if which == "match":
        return info.get("match_least_s", lambda launches: None)(n)
    per = info.get(which + "_least_s")
    return None if per is None or not n else per * n


def roofline_pct(ctx, which):
    t, _ = kernel(ctx, which)
    least = least_s(ctx, which)
    if least is None or t <= 0:
        return None
    return 100.0 * least / t


def step_least_s(ctx):
    """Least seconds of the counted work of the window: the three
    kernels, rBRIEF with its angle and the detector's convolutions."""
    parts = [least_s(ctx, k) for k in KERNELS]
    if any(p is None for p in parts):
        return None
    info = ctx["info"]
    extracts = info["extracts"]
    brief = extracts * counts.brief_least_s(info["extract_frames"] * info["features"])
    det = 0.0
    if info.get("detector"):
        det = extracts * info["extract_frames"] * info["yolo_flops"] / counts.BF16_OPS_PER_S
    return sum(parts) + brief + det
