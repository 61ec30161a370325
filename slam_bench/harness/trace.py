"""Spans on the host clock and the device trace of a traced run.

Spans: a stage timer with the program's StageTimer interface
(`stage(name)`), which keeps every span; with `sync` each span ends with
torch.cuda.synchronize(), so a span holds the device work it launched
(only a traced run does that).

Profiler: torch.profiler with CUDA activity over the window. From its
kineto events it reduces the device's busy time (the union of kernel,
copy and set intervals), the launches, each kernel's time by name, the
top device operations and the longest idle gaps labelled by the span
the host was in when the gap began.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from collections import defaultdict


class Spans:
    def __init__(self, sync: bool = False):
        self.sync = sync
        self.events = []  # (name, t0, t1) on time.perf_counter

    def clear(self):
        self.events = []

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if self.sync:
                import torch

                torch.cuda.synchronize()
            self.events.append((name, t0, time.perf_counter()))

    def by_name(self):
        out = defaultdict(list)
        for name, t0, t1 in self.events:
            out[name].append(t1 - t0)
        return dict(out)


# spans that hold others: a gap is labelled by the innermost stage
OUTER = ("chunk", "round")


class Profiler:
    def __init__(self, on_card: bool):
        self.on_card = on_card
        self.prof = None
        self.t_mark = None

    def start(self):
        import torch

        acts = [torch.profiler.ProfilerActivity.CUDA] if self.on_card else \
            [torch.profiler.ProfilerActivity.CPU]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()

    def mark(self, t_host):
        """A marker launch at host time t_host: its runtime call in the
        trace ties the trace's clock to time.perf_counter."""
        import torch

        self.t_mark = t_host
        if self.on_card:
            torch.cuda.synchronize()
            self.t_mark = time.perf_counter()
            torch.empty(1, device="cuda").fill_(0.0)

    def stop(self, spans: Spans) -> dict:
        import torch

        if self.on_card:
            torch.cuda.synchronize()
        t_end = time.perf_counter()
        self.prof.__exit__(None, None, None)
        return reduce(self.prof, spans, self.t_mark, t_end, self.on_card)


def reduce(prof, spans, t_mark, t_end, on_card):
    intervals, by_name, launches = [], defaultdict(float), 0
    counts = defaultdict(int)
    runtime_first = None
    for ev in prof.profiler.kineto_results.events():
        kind = str(ev.device_type()).split(".")[-1].lower()
        name = ev.name()
        start = ev.start_ns() * 1e-9
        dur = ev.duration_ns() * 1e-9
        if kind == "cuda":
            intervals.append((start, start + dur))
            by_name[name] += dur
            counts[name] += 1
            launches += 1
        elif name in ("cudaLaunchKernel", "cudaLaunchKernelExC") and (
                runtime_first is None or start < runtime_first):
            runtime_first = start
    window_s = t_end - t_mark
    busy = 0.0
    gaps = []
    if intervals:
        intervals.sort()
        cur_s, cur_e = intervals[0]
        for s, e in intervals[1:]:
            if s > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, s))
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
    # the trace's clock against the host's: the marker's launch call
    offset = (runtime_first - t_mark) if runtime_first is not None else None
    labelled = defaultdict(float)
    inner = sorted((a, b, name) for name, a, b in spans.events if name not in OUTER)
    starts = [a for a, _, _ in inner]
    for s, e in gaps:
        label = "outside any span"
        if offset is not None:
            th = s - offset
            i = bisect.bisect_right(starts, th) - 1
            for a, b, name in inner[max(0, i - 3): i + 1][::-1]:
                if a <= th < b:
                    label = name
                    break
        labelled[label] += e - s
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    top_gaps = sorted(labelled.items(), key=lambda kv: -kv[1])[:10]
    return dict(busy_s=busy, window_s=window_s, launches=launches, kernels=dict(by_name),
                counts=dict(counts),
                breakdown={"device_ops": [[n, s] for n, s in top_ops],
                           "idle_gaps": [[n, s] for n, s in top_gaps]})
