"""The port's span and counter recorder (utils/profiling.py): it records
only inside a torch profiler, with nesting and parents; a given timer
gets every span; counters add up; each profiler session starts empty;
the chunked evaluator and the batched front end give the same outputs
with recording on and off, with every span and counter present when on,
and the evaluator's timer gets its inner spans only while recording;
torch still has the private profiler hooks the recorder reads;
`attribute` on a synthetic event list. The test marked `card` runs the
evaluator under `device_trace` on a CUDA card and skips here:

    python -m pytest --noconftest -m card tests/test_torch_profiling.py
"""

import dataclasses
import sys
import threading
import types

import numpy as np
import pytest
import torch

from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch.eval import multi_eval
from aria_slam_tpu_torch.eval.chunked import ChunkedSlam
from aria_slam_tpu_torch.io import synthetic_scene
from aria_slam_tpu_torch.utils import profiling
from aria_slam_tpu_torch.utils.profiling import TraceEvent, span

CPU = [torch.profiler.ProfilerActivity.CPU]

# the chunked evaluator's spans and counters, all present in the small run
CHUNKED_SPANS = {"frontend", "frontend.extract", "frontend.detect", "detect.forward",
                 "detect.post", "frontend.pairs", "fetch", "state_update", "loop_query",
                 "loop_verify", "loop_optimize", "finalize.optimize", "pose_graph.linearize",
                 "pose_graph.pcg", "pose_graph.accept"}
# those ChunkedSlam hands its timer, recording or not
CHUNKED_TIMED = {"frontend", "chunk_ba", "imu_scale", "loop_query", "state_update",
                 "backbone_edges", "loop_verify", "loop_optimize", "finalize.optimize"}
CHUNKED_COUNTERS = {"frontend.matches", "frontend.dyn_removed", "loop.verified",
                    "loop.accepted"}
MULTI_SPANS = {"multi.extract", "multi.match", "multi.ransac", "multi.pins"}


def _session(fn, activities=CPU):
    """fn() inside a profiler session -> (its result, the session's Record)."""
    with torch.profiler.profile(activities=activities):
        out = fn()
    return out, profiling.recorded()


# ------------------------------------------------------------- recorder
def test_spans_record_only_inside_a_profiler_with_their_parents():
    _session(lambda: None)
    with span("outside"):
        pass
    assert profiling.recorded().spans == []
    assert span("a") is span("b")  # off: one shared null context

    def nested():
        with span("outer"):
            with span("inner"):
                pass
            with span("inner"):
                pass
        with span("second"):
            pass

    _, rec = _session(nested)
    assert [(n, p) for n, p, _, _ in rec.spans] == [
        ("outer", -1), ("inner", 0), ("inner", 0), ("second", -1)]
    (_, _, o0, o1), (_, _, a0, a1), (_, _, b0, b1), (_, _, s0, s1) = rec.spans
    assert o0 <= a0 <= a1 <= b0 <= b1 <= o1 <= s0 <= s1
    assert rec.total_s("inner") == pytest.approx((a1 - a0) + (b1 - b0))
    assert rec.total_s("missing") is None


def test_a_given_timer_gets_every_span_with_or_without_a_profiler():
    timer = profiling.StageTimer()

    def run():
        with span("stage", timer):
            with span("child"):  # enters its parent's timer while recording
                pass

    run()
    assert set(timer.first_ms) == {"stage"}
    _session(run)
    assert set(timer.first_ms) == {"stage", "child"}
    assert timer.summary()["stage"]["count"] == 2


def test_counters_add_up_while_recording():
    def run():
        profiling.count("c")
        profiling.count("c", 4)
        profiling.count("d", np.int64(2))

    profiling.count("c", 100)  # no profiler: not counted
    _, rec = _session(run)
    assert rec.counters == {"c": 5, "d": 2}


def test_a_second_session_starts_empty():
    def first():
        with span("one"):
            profiling.count("n")

    _, rec = _session(first)
    assert [s[0] for s in rec.spans] == ["one"] and rec.counters == {"n": 1}
    _, rec = _session(lambda: None)
    assert rec.spans == [] and rec.counters == {}


def test_the_profilers_private_hooks_are_there():
    """span reads torch's private profiler flag and restarts the record
    from its private start hook: a torch without them leaves spans off
    (and the port importable), which this test makes loud."""
    import torch.autograd.profiler as autograd_profiler

    assert profiling._PROFILER is autograd_profiler
    assert isinstance(autograd_profiler._is_profiler_enabled, bool)
    assert autograd_profiler._run_on_profiler_start.restarts_record
    assert profiling._hook_profiler_start(types.SimpleNamespace()) is False


def test_spans_past_the_cap_are_dropped_and_counted(monkeypatch):
    monkeypatch.setattr(profiling, "MAX_SPANS", 2)
    timer = profiling.StageTimer()

    def run():
        for _ in range(3):
            with span("s", timer):
                pass

    _, rec = _session(run)
    assert len(rec.spans) == 2 and rec.counters == {profiling.DROPPED: 1}
    assert timer.summary()["s"]["count"] == 3  # the timer still gets it


def test_threads_keep_their_own_parents_and_counts():
    """Eight threads open nested spans and count at once, the interpreter
    switching threads every few microseconds: each inner span's parent
    is its own thread's outer span, and no count is lost."""
    n_threads, n_spans = 8, 200

    def worker(k):
        for _ in range(n_spans):
            with span(f"outer{k}"):
                with span(f"inner{k}"):
                    profiling.count("n")

    def run():
        switch = sys.getswitchinterval()
        sys.setswitchinterval(1e-6)
        try:
            threads = [threading.Thread(target=worker, args=(k,)) for k in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(switch)

    _, rec = _session(run)
    assert rec.counters == {"n": n_threads * n_spans}
    assert len(rec.spans) == 2 * n_threads * n_spans
    for name, parent, _, _ in rec.spans:
        if name.startswith("inner"):
            assert rec.spans[parent][0] == "outer" + name[len("inner"):]


def test_attribute_on_a_synthetic_trace():
    """A nested span, an idle gap inside it, a launch outside every span
    and a device event whose call is not in the trace."""
    ev = [TraceEvent("span", "outer", 0.0, 10.0), TraceEvent("span", "inner", 2.0, 5.0),
          TraceEvent("call", "cudaLaunchKernel", 1.0, 1.1, 1),
          TraceEvent("call", "cudaLaunchKernel", 3.0, 3.1, 2),
          TraceEvent("call", "cudaMemcpyAsync", 4.0, 4.1, 3),
          TraceEvent("call", "cudaLaunchKernel", 11.0, 11.1, 4),
          TraceEvent("device", "k1", 1.2, 2.2, 1), TraceEvent("device", "k2", 3.2, 3.5, 2),
          TraceEvent("device", "copy", 4.2, 4.4, 3), TraceEvent("device", "k4", 11.2, 11.8, 4),
          TraceEvent("device", "lost", 12.0, 12.5, 99)]
    table = profiling.attribute_events(ev)
    # gaps: 2.2-3.2 (inner open), 3.5-4.2 (inner), 4.4-11.2 (inner: the
    # gap begins inside it), 11.8-12.0 (outside)
    assert table["outer"]["launches"] == 1
    assert table["outer"]["device_s"] == pytest.approx(1.0)
    assert table["outer"]["idle_s"] == 0.0
    assert table["inner"]["launches"] == 2
    assert table["inner"]["device_s"] == pytest.approx(0.5)
    assert table["inner"]["idle_s"] == pytest.approx(1.0 + 0.7 + 6.8)
    out = table[profiling.OUTSIDE]
    assert out["launches"] == 2
    assert out["device_s"] == pytest.approx(1.1)
    assert out["idle_s"] == pytest.approx(0.2)
    assert sum(r["launches"] for r in table.values()) == 5
    assert "inner" in profiling.format_attribution(table)


# ------------------------------------------------------- the chunked path
def _chunked_config():
    """A small loop-closure configuration whose low gates verify and
    accept loops between frames four apart, a tiny detector with random
    weights whose one box a frame removes some of the matches, and short
    optimisations."""
    cam = tcfg.CameraConfig(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                            k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    return tcfg.PipelineConfig(
        camera=cam, orb=tcfg.OrbConfig(num_features=256, num_levels=2),
        ransac=tcfg.RansacConfig(num_hypotheses=64),
        pose_graph=tcfg.PoseGraphConfig(max_nodes=64, max_edges=128, lm_iterations=2,
                                        cg_iterations=8, final_lm_iterations=2),
        loop=tcfg.LoopClosureConfig(max_keyframes=16, min_frames_between=4, min_score=0.1,
                                    min_matches=40),
        chunk_ba=tcfg.ChunkBaConfig(enabled=False), imu_metric_scale=False,
        enable_loop_closure=True, enable_fusion=False, enable_mapping=False,
        enable_detection=True, enable_dynamic_filtering=True,
        detector=tcfg.DetectorConfig(input_size=64, width_mult=0.25, max_detections=1))


CHUNK = 5


@pytest.fixture(scope="module")
def sweep():
    """16 frames of a 4 s sweep at 5 fps."""
    cam = _chunked_config().camera
    layers = synthetic_scene.scene_layers(4.0, 0)
    ts = np.arange(3 * CHUNK + 1) / 5.0
    frames = np.stack([synthetic_scene.render_frame(
        cam, None, *synthetic_scene.trajectory(t, period=4.0), layers=layers) for t in ts])
    return frames.astype(np.uint8), ts


def _chunked_run(frames, ts, timer=None):
    slam = ChunkedSlam(_chunked_config(), chunk=CHUNK, seed=3, device="cpu", timer=timer)
    for k in range(3):
        s = k * CHUNK
        slam.process_chunk(frames[s:s + CHUNK + 1], ts[s:s + CHUNK + 1])
    slam.finalize()
    return slam


def test_chunked_outputs_equal_with_recording_on_and_off(sweep):
    timer_off, timer_on = profiling.StageTimer(), profiling.StageTimer()
    off = _chunked_run(*sweep, timer_off)
    on, rec = _session(lambda: _chunked_run(*sweep, timer_on))
    assert np.array_equal(np.stack([T for _, T in off.trajectory]),
                          np.stack([T for _, T in on.trajectory]))
    assert torch.equal(off.graph.node_pose, on.graph.node_pose)
    assert off.loop_pairs == on.loop_pairs
    names = {s[0] for s in rec.spans}
    assert CHUNKED_SPANS <= names, CHUNKED_SPANS - names
    assert CHUNKED_COUNTERS <= set(rec.counters)
    c = rec.counters
    assert c["loop.verified"] >= c["loop.accepted"] == len(on.loop_pairs) > 0
    assert c["frontend.matches"] > c["frontend.dyn_removed"] > 0
    # two LM iterations in finalize and in each loop optimisation
    optimizations = 1 + sum(1 for s in rec.spans if s[0] == "loop_optimize")
    for name in ("pose_graph.linearize", "pose_graph.pcg", "pose_graph.accept"):
        assert sum(1 for s in rec.spans if s[0] == name) == 2 * optimizations
    parents = {rec.spans[p][0] for n, p, _, _ in rec.spans if n == "detect.forward"}
    assert parents == {"frontend.detect"}
    parents = {rec.spans[p][0] for n, p, _, _ in rec.spans if n == "pose_graph.pcg"}
    assert parents == {"loop_optimize", "finalize.optimize"}
    # untraced, the timer gets the evaluator's own stages and no inner span
    # (a synchronising timer would wait at each); while recording, all
    assert set(timer_off.first_ms) == CHUNKED_TIMED & names
    assert set(timer_on.first_ms) == names


# ------------------------------------------------- the batched front end
def test_multi_frontend_equal_with_recording_on_and_off(sweep):
    frames, _ = sweep
    cfg = dataclasses.replace(_chunked_config(), enable_detection=False)
    fe = multi_eval.make_multi_chunk_frontend(cfg)
    fr = torch.from_numpy(np.stack([frames[:4], frames[4:8]]))
    gR = torch.eye(3).expand(2, 3, 3, 3).contiguous()
    gok = torch.zeros((2, 3), dtype=torch.bool)

    def run():
        sampler = multi_eval.SequenceSampler(
            [torch.Generator().manual_seed(q) for q in range(2)])
        return fe(fr, sampler, gR, gok)

    off = run()
    on, rec = _session(run)
    for a, b in zip(off, on):
        assert torch.equal(a, b)
    assert MULTI_SPANS <= {s[0] for s in rec.spans}


# ------------------------------------------------------------ on the card
@pytest.mark.card
def test_attribution_under_device_trace_on_the_card(sweep, tmp_path):
    """On a CUDA card: the recorder records under the benchmark's
    CUDA-only profiler; under `device_trace` every kernel, copy and set
    is attributed once, and at least 90 % of them to a span."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    frames, ts = sweep

    def run():
        slam = ChunkedSlam(_chunked_config(), chunk=CHUNK, seed=3, device="cuda")
        for k in range(3):
            s = k * CHUNK
            slam.process_chunk(frames[s:s + CHUNK + 1], ts[s:s + CHUNK + 1])
        slam.finalize()
        torch.cuda.synchronize()

    run()  # builds the kernels
    _, rec = _session(run, [torch.profiler.ProfilerActivity.CUDA])
    assert CHUNKED_SPANS <= {s[0] for s in rec.spans}
    assert CHUNKED_COUNTERS <= set(rec.counters)
    with profiling.device_trace(str(tmp_path), "cuda") as prof:
        run()
    launches = sum(1 for e in prof.profiler.kineto_results.events()
                   if str(e.device_type()).endswith("CUDA") and not e.is_user_annotation())
    table = profiling.attribute(prof)
    assert sum(r["launches"] for r in table.values()) == launches > 0
    inside = launches - table.get(profiling.OUTSIDE, {"launches": 0})["launches"]
    assert inside >= 0.9 * launches, profiling.format_attribution(table)
