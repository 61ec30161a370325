"""The online step's spans and counters (pipeline/slam_pipeline.py,
loop_closure.detect, models/detect.make_detector) on the CPU: the small
revisiting scene of tests/test_torch_online.py with a TINY detector at
B = 1, its last frames (which close the loops) inside a profiler
session: every span is there, each nested
under the stage that holds it, a given timer gets the step's own stages
and the host-side ones, online.loops equals the pipeline's loop count
and the verify counters agree with it; the same run without a profiler
gives the same trajectory."""

import dataclasses

import numpy as np
import pytest
import torch

from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch.io import synthetic_scene as tsynth
from aria_slam_tpu_torch.models import detect
from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline
from aria_slam_tpu_torch.utils import profiling

from torch_parity_util import ONLINE_SCENE, ONLINE_SEED, online_config

TINY = tcfg.DetectorConfig(input_size=64, width_mult=0.25, depth_mult=0.33, conf_threshold=0.9)

# the step's stages, each handed the pipeline's timer, and where the
# host-side spans sit
STEP = ("online.extract", "online.detect", "online.match", "online.pose", "online.map",
        "online.loop_detect", "online.db_insert")
HOST = ("online.publish", "online.loop_optimize")
PARENTS = {"detect.forward": "online.detect", "detect.post": "online.detect",
           "online.ekf": "online.publish", "pose_graph.linearize": "online.loop_optimize",
           "pose_graph.pcg": "online.loop_optimize", "pose_graph.accept": "online.loop_optimize"}


def _frames(n):
    layers = tsynth.scene_layers(4.0, 0)
    cam = online_config(tcfg).camera
    return [tsynth.render_frame(cam, None, *tsynth.trajectory(k / ONLINE_SCENE["fps"],
                                                              period=ONLINE_SCENE["period"]),
                                depth=4.0, layers=layers)
            for k in range(n)]


# the frames recorded: the last ones, which revisit the first (a profiler
# session with CPU activity makes every op several times slower)
RECORDED = 5


def _run(frames, timer=None, record=False):
    """The pipeline over the frames, the last RECORDED inside a profiler
    session when `record` -> (pipeline, the session's Record or None)."""
    cfg = dataclasses.replace(online_config(tcfg), enable_detection=True,
                              enable_dynamic_filtering=True, detector=TINY)
    pipe = SlamPipeline(cfg, device="cpu", seed=ONLINE_SEED, timer=timer,
                        detector=detect.make_detector(TINY, device="cpu"))
    first = len(frames) - RECORDED if record else len(frames)
    for k in range(first):
        pipe.process_frame(frames[k], 0.1 * k)
    if not record:
        return pipe, None
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        for k in range(first, len(frames)):
            pipe.process_frame(frames[k], 0.1 * k)
    return pipe, profiling.recorded()


@pytest.fixture(scope="module")
def traced():
    frames = _frames(ONLINE_SCENE["num_frames"])
    timer = profiling.StageTimer()
    pipe, rec = _run(frames, timer, record=True)
    return frames, pipe, timer, rec


def test_every_online_span_is_recorded_under_its_stage(traced):
    frames, pipe, _, rec = traced
    names = [n for n, _, _, _ in rec.spans]
    for name in STEP + HOST + tuple(PARENTS) + ("fetch",):
        assert name in names, name
    for name in STEP + ("online.publish",):
        assert names.count(name) == RECORDED, name
    for name, parent, _, _ in rec.spans:
        if name in STEP + HOST:
            assert parent == -1, name
        elif name in PARENTS:
            assert rec.spans[parent][0] == PARENTS[name], name
    # the B = 1 detector's two spans once a frame
    assert names.count("detect.forward") == names.count("detect.post") == RECORDED


def test_the_timer_gets_the_stages(traced):
    frames, pipe, timer, _ = traced
    got = timer.summary()
    for name in STEP + ("online.publish",):
        assert got[name]["count"] == len(frames), name
    assert got["online.loop_optimize"]["count"] == pipe.num_loops
    # the inner spans enter it only while recording
    assert got["detect.forward"]["count"] == got["online.ekf"]["count"] == RECORDED


def test_online_counters(traced):
    frames, pipe, _, rec = traced
    c = rec.counters
    assert c.get("online.loops", 0) >= 1, "the recorded frames closed no loop"
    assert c["online.frames"] == RECORDED
    # every loop of the run lies among the recorded frames
    assert c["online.loops"] == pipe.num_loops == len(pipe.loop_pairs)
    assert pipe.num_loops <= c["online.loop_queries"] <= RECORDED
    assert c["online.loop_queries"] <= c["online.loop_verified"] <= (
        online_config(tcfg).loop.top_k_candidates * c["online.loop_queries"])


def test_spans_do_not_change_the_run(traced):
    frames, pipe, _, _ = traced
    plain, _ = _run(frames)
    np.testing.assert_array_equal(np.stack([T for _, T in plain.trajectory]),
                                  np.stack([T for _, T in pipe.trajectory]))
    assert plain.loop_pairs == pipe.loop_pairs
