"""Spans, counters, per-stage timing and device traces (counterpart of the
JAX package's utils/profiling.py).

span(name, timer=None): a named region of the program, as a context
manager. It records only while a torch profiler records in this process
(`torch.profiler.profile`, or autograd's profiler): then it keeps
(name, parent span, t0, t1) on time.perf_counter, the parent being the
innermost span open in the thread, and opens
`torch.profiler.record_function(name)`, so a trace with CPU activity
holds every span on the device trace's own clock. A span never
synchronises by itself. Given a `timer` (the StageTimer interface,
`timer.stage(name)`) the span always enters it, recording or not; while
recording, a span given none enters its parent's, so a synchronising
timer holds every span nested in one of its own. The port hands a timer
only to the spans its callers time (a ChunkedSlam's stages, run_scenes',
euroc_eval's); the spans inside them take none, so untraced they never
reach a synchronising timer. With no profiler and no timer a span is
one flag check and a shared null context. The profiler's flag and start
hook are private to torch (`torch.autograd.profiler._is_profiler_enabled`
and `_run_on_profiler_start`); on a torch without them spans never
record and still enter their timers.

count(name, n=1) adds to a named counter while spans record. recorded()
is the current session's Record (spans and counters): a new profiler
session starts an empty one, and it is read after its session ends. At
most MAX_SPANS spans are kept a session; the rest are counted under
DROPPED.

The port's spans:
  eval/chunked.ChunkedSlam   frontend (frontend.extract, frontend.detect
      with detect.forward and detect.post, frontend.pairs, fetch),
      chunk_ba, imu_scale, loop_query (fetch), state_update,
      backbone_edges, loop_verify (fetch), loop_optimize (pose_graph.*);
      finalize.optimize (pose_graph.*) in finalize
  pipeline/slam_pipeline.SlamPipeline   online.extract, online.detect
      (detect.forward and detect.post, the box test), online.match,
      online.pose, online.map, online.loop_detect,
      online.db_insert, each frame's step; online.publish (fetch,
      online.ekf) as each frame publishes; online.loop_optimize (fetch,
      pose_graph.*) as it applies a loop
  backend/pose_graph.optimize   pose_graph.linearize, pose_graph.pcg,
      pose_graph.accept, each LM iteration
  models/detect.make_batched_detector, make_detector   detect.forward,
      detect.post
  eval/multi_eval.make_multi_chunk_frontend   multi.extract,
      multi.match, multi.ransac, multi.pins
  eval/multi_eval.run_scenes   round, decode_wait, frontend, chain
  pipeline/slam_pipeline.fetch_many   fetch (the host's wait for the
      device and the copy)
  eval/euroc_eval   decode (its worker thread), decode_wait, gyro_prior,
      device_chunk, imu, frame_step
  fusion/ekf.run_sequence   ekf_forward, ekf_smoother
and counters: frontend.matches (the chunk's ratio-passing consecutive
matches with valid endpoints, before the dynamic mask),
frontend.dyn_removed (those the dynamic mask removed), loop.verified
(candidates in a verify batch), loop.accepted (loop edges added),
online.frames (frames SlamPipeline stepped), online.loop_queries (frames
whose gated top score passed, so loop_closure.detect verified),
online.loop_verified (their candidates), online.loops (loops applied),
pose_graph.graphed_iters (LM iterations replayed as CUDA graphs),
pose_graph.eager_iters (LM iterations run op by op: on the CPU, or the
warm-up before a capture), pose_graph.captures (captures made).

attribute(prof): for a finished torch.profiler.profile with CPU and CUDA
activity, each span's launches (kernels, copies and sets whose runtime
call falls inside the span's record_function range, matched by
correlation id), their device seconds, and the device's idle gaps
labelled by the innermost span open when each began.

StageTimer: host wall clock around a named stage. Handed a CUDA
`device`, the stage ends with torch.cuda.synchronize(), so the device
work a stage launched is charged to that stage and not to whichever
later stage first waits for it; without one it never synchronises. The
first event of every stage is kept apart as `warm_ms` (kernel builds,
allocator growth, library initialisation) and excluded from the steady
statistics.

device_trace: torch.profiler around a region, written as a trace for
TensorBoard's profiler plugin (the reference's jax.profiler trace).
"""

from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import numpy as np
import torch
import torch.autograd.profiler as _autograd_profiler

MAX_SPANS = 1 << 18
DROPPED = "profiling.dropped_spans"
OUTSIDE = "outside any span"

_NULL = contextlib.nullcontext()


@dataclasses.dataclass
class Record:
    """One profiler session: spans [(name, parent index or -1, t0, t1)]
    in the order they opened (t1 None while open), counters {name: n}."""

    spans: list
    counters: dict

    def total_s(self, name: str) -> Optional[float]:
        """Seconds in the closed spans of `name`; None when there is none."""
        ds = [t1 - t0 for n, _, t0, t1 in self.spans if n == name and t1 is not None]
        return float(sum(ds)) if ds else None


class _Recorder:
    """The process's record. The profiler is one per process, so its
    record is too; a profiler start replaces it (`_hook_profiler_start`)."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.lock = threading.Lock()
        self.local = threading.local()

    def restart(self):
        with self.lock:
            self.spans, self.counters = [], {}

    def stack(self) -> list:
        try:
            return self.local.stack
        except AttributeError:
            self.local.stack = []
            return self.local.stack


_RECORDER = _Recorder()


def _hook_profiler_start(module) -> bool:
    """Start a fresh record with every profiler session: torch calls
    `module._run_on_profiler_start` as any profiler starts, the call that
    raises the flag `module._is_profiler_enabled` that `span` checks.
    -> False, hooking nothing, when `module` lacks either."""
    start = getattr(module, "_run_on_profiler_start", None)
    if not callable(start) or not hasattr(module, "_is_profiler_enabled"):
        return False
    if getattr(start, "restarts_record", False):
        return True

    def on_start():
        start()
        _RECORDER.restart()

    on_start.restarts_record = True
    module._run_on_profiler_start = on_start
    return True


class _NeverRecording:
    _is_profiler_enabled = False


# where span reads the profiler's flag: a torch without the private hooks
# leaves spans off rather than the port unimportable
_PROFILER = (_autograd_profiler if _hook_profiler_start(_autograd_profiler)
             else _NeverRecording)


def recording() -> bool:
    """True while a profiler records, so spans and counters do."""
    return bool(_PROFILER._is_profiler_enabled)


def span(name: str, timer=None):
    """A context manager around a named region (see the module's
    docstring)."""
    if _PROFILER._is_profiler_enabled:
        return _recorded_span(name, timer)
    return _NULL if timer is None else timer.stage(name)


@contextlib.contextmanager
def _recorded_span(name: str, timer) -> Iterator[None]:
    rec = _RECORDER
    spans = rec.spans
    stack = rec.stack()
    parent = -1
    if stack and stack[-1][0] is spans:
        parent = stack[-1][1]
        timer = stack[-1][2] if timer is None else timer
    entry = None
    if len(spans) < MAX_SPANS:
        entry = [name, parent, time.perf_counter(), None]
        with rec.lock:  # the index is the entry's, whatever other threads append
            spans.append(entry)
            index = len(spans) - 1
        stack.append((spans, index, timer))
    else:
        count(DROPPED)
        stack.append((spans, parent, timer))
    try:
        with torch.profiler.record_function(name):
            if timer is None:
                yield
            else:
                with timer.stage(name):
                    yield
    finally:
        stack.pop()
        if entry is not None:
            entry[3] = time.perf_counter()


def count(name: str, n=1) -> None:
    """Add n to the counter `name` while spans record."""
    if _PROFILER._is_profiler_enabled:
        rec = _RECORDER
        with rec.lock:
            rec.counters[name] = rec.counters.get(name, 0) + int(n)


def recorded() -> Record:
    """A copy of the current (or last) session's spans and counters."""
    rec = _RECORDER
    with rec.lock:
        return Record([tuple(s) for s in rec.spans], dict(rec.counters))


# ------------------------------------------------------------ attribution
@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One event of a trace, in seconds on the trace's clock. kind:
    "span" (a record_function range on the host), "call" (a runtime call
    that puts work on the device) or "device" (a kernel, copy or set);
    a device event and its call share `corr`."""

    kind: str
    name: str
    t0: float
    t1: float
    corr: int = 0


def trace_events(prof) -> list:
    """The TraceEvents of a finished torch.profiler.profile."""
    out = []
    for ev in prof.profiler.kineto_results.events():
        on_device = str(ev.device_type()).endswith("CUDA")
        name = ev.name()
        t0 = ev.start_ns() * 1e-9
        t1 = t0 + ev.duration_ns() * 1e-9
        if ev.is_user_annotation():
            if not on_device:  # the range's copy on the device is no work
                out.append(TraceEvent("span", name, t0, t1))
        elif on_device:
            out.append(TraceEvent("device", name, t0, t1, ev.correlation_id()))
        elif name.startswith("cu"):
            out.append(TraceEvent("call", name, t0, t1, ev.correlation_id()))
    return out


def attribute(prof) -> Dict[str, Dict[str, float]]:
    """{span name: {"launches", "device_s", "idle_s"}} of a finished
    torch.profiler.profile with CPU and CUDA activity; OUTSIDE holds the
    launches whose call is in no span (or not in the trace) and the idle
    that began outside every span. See attribute_events."""
    return attribute_events(trace_events(prof))


def attribute_events(events) -> Dict[str, Dict[str, float]]:
    """Each device event goes to the innermost span (the latest-opened
    one) open at the start of its runtime call; each idle gap of the
    device (between the union of its events' intervals) to the innermost
    span open when the gap began."""
    spans = sorted((e for e in events if e.kind == "span"), key=lambda e: e.t0)
    calls = {e.corr: e.t0 for e in events if e.kind == "call"}
    device = sorted((e for e in events if e.kind == "device"), key=lambda e: e.t0)
    queries = []  # (host time or None, launch event or None, idle seconds)
    end = None
    for e in device:
        queries.append((calls.get(e.corr), e, 0.0))
        if end is not None and e.t0 > end:
            queries.append((end, None, e.t0 - end))
        end = e.t1 if end is None else max(end, e.t1)
    table = defaultdict(lambda: {"launches": 0, "device_s": 0.0, "idle_s": 0.0})
    opened, i = [], 0
    for t, ev, idle in sorted(queries, key=lambda q: -1.0 if q[0] is None else q[0]):
        label = OUTSIDE
        if t is not None:
            while i < len(spans) and spans[i].t0 <= t:
                opened.append(spans[i])
                i += 1
            opened = [s for s in opened if s.t1 > t]
            if opened:
                label = opened[-1].name
        row = table[label]
        if ev is None:
            row["idle_s"] += idle
        else:
            row["launches"] += 1
            row["device_s"] += ev.t1 - ev.t0
    return dict(table)


def format_attribution(table) -> str:
    """The attribution as lines, the largest device plus idle time first."""
    lines = []
    for name, r in sorted(table.items(), key=lambda kv: -(kv[1]["device_s"] + kv[1]["idle_s"])):
        lines.append(f"{name:>24s}: launches {r['launches']:8d}  device "
                     f"{1e3 * r['device_s']:10.2f} ms  idle {1e3 * r['idle_s']:10.2f} ms")
    return "\n".join(lines)


# ------------------------------------------------------------ stage timer
class StageTimer:
    """Accumulates wall-clock per named stage; cheap enough for per-chunk
    use. `mean_ms`/`p50_ms`/`p95_ms`/`total_ms` describe the events after
    the first; a stage observed once reports its single event as both
    warm_ms and the steady statistics. Synchronises at a stage's end only
    when handed a CUDA `device`."""

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


@contextlib.contextmanager
def device_trace(logdir: str, device=None) -> Iterator[torch.profiler.profile]:
    """torch.profiler over the region, its trace written under logdir
    when the region ends; the card's kernels are recorded when `device`
    (CUDA unless given) is a CUDA device."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.device("cuda" if device is None else device).type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(logdir)) as prof:
        yield prof
