"""The port's navigation-assistance loop (aria_slam_tpu_torch/examples/
aria_navigation.py) on the CPU: headless against the JAX package's
examples/aria_navigation.py on the same 5 frames of a 320x240 sweep
(the configuration each builds, and frame by frame the poses with the
port drawing the JAX pipeline's RANSAC key chain); the staged pipeline
against synchronous process_frame; the --detect hand-off to the audio
engine at a narrow detector width; a stage that raises fails the run;
the card unless asked."""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax

from aria_slam_tpu.pipeline import factory as jfactory
from aria_slam_tpu_torch.config import DetectorConfig
from aria_slam_tpu_torch.examples import aria_navigation as nav
from aria_slam_tpu_torch.io.euroc import decode_png_gray8, encode_png_gray8
from aria_slam_tpu_torch.pipeline import async_pipeline, factory
from aria_slam_tpu_torch.utils.audio import NavigationAudioEngine

import torch_parity_util
from torch_parity_util import JaxChainSampler, rendered_frames

FRAMES = 5
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def image_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("nav")
    for k, img in enumerate(rendered_frames(FRAMES, fps=10.0)):
        (d / f"{k:04d}.png").write_bytes(encode_png_gray8(img.astype(np.uint8)))
    return str(d)


def _record(factory_module, monkeypatch, **create_kw):
    """Wrap factory_module.create: the config it gets, and for every frame
    the pipeline steps (the warm-up first) its pose, features, matches,
    inliers and success flag, and its detections on the host."""
    real_create = factory_module.create
    seen = {"frames": [], "detections": []}

    def create(*a, **kw):
        pipe = real_create(*a, **kw, **create_kw)
        step = pipe.process_frame

        def process_frame(*fa, **fkw):
            pose = np.asarray(step(*fa, **fkw))
            o = pipe.last_output
            seen["frames"].append((pose, int(o.num_features), int(o.num_matches),
                                   int(o.num_inliers), bool(o.vo_success)))
            d = o.detections
            seen["detections"].append(tuple(np.asarray(x) for x in (d.boxes, d.classes,
                                                                      d.valid)))
            return pose

        pipe.process_frame = process_frame
        seen["config"] = pipe.config
        return pipe

    monkeypatch.setattr(factory_module, "create", create)
    return seen


def test_example_matches_jax(image_dir, monkeypatch):
    """Both examples headless on the same frames, --detect off: the same
    configuration (camera fx = fy = 0.9 w = 288 at the centre, no
    distortion; 512 features, 4 levels, 128 hypotheses; detection,
    filtering, loop closure and mapping off), no frame dropped (5 frames
    cannot fill the drop threshold of 4), and frame by frame, the warm-up
    first, the features and matches equal, the inliers within 2, the
    success flags equal and the poses within 2e-3, the online parity
    tests' gates (tests/test_torch_demo.py)."""
    spec = importlib.util.spec_from_file_location(
        "jax_aria_navigation", os.path.join(REPO, "examples", "aria_navigation.py"))
    jnav = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jnav)
    jseen = _record(jfactory, monkeypatch)
    monkeypatch.setattr(sys, "argv", ["aria_navigation.py", image_dir])
    jnav.main()

    tseen = _record(factory, monkeypatch, sampler=JaxChainSampler(jax.random.key(0)))
    res = nav.run(image_dir, device="cpu", verbose=False)

    jcfg, tcfg = jseen["config"], tseen["config"]
    assert tcfg.to_dict() == jcfg.to_dict()
    cam = tcfg.camera
    assert (cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy, cam.k1) == (
        320, 240, 288.0, 288.0, 160.0, 120.0, 0.0)
    assert (tcfg.orb.num_features, tcfg.orb.num_levels, tcfg.ransac.num_hypotheses) == (
        512, 4, 128)
    assert not (tcfg.enable_detection or tcfg.enable_dynamic_filtering
                or tcfg.enable_loop_closure or tcfg.enable_mapping)
    assert (res["submitted"], res["processed"], res["dropped"]) == (FRAMES, FRAMES, 0)
    jframes, tframes = jseen["frames"], tseen["frames"]
    assert len(jframes) == len(tframes) == FRAMES + 1
    for (jp, fj, mj, ij, okj), (tp, ft, mt, it, okt) in zip(jframes, tframes):
        assert (ft, mt, okt) == (fj, mj, okj)
        assert abs(it - ij) <= 2, (ij, it)
        np.testing.assert_allclose(tp, jp, atol=2e-3)
    assert sum(ok for *_, ok in tframes) >= FRAMES - 1
    ts = [t for t, _ in res["results"]]
    assert ts == sorted(ts)
    assert res["descriptions"] >= 1 and res["fused_finite"]
    assert res["imu_emitted"] >= res["imu_consumed"] + res["imu_buffered"]
    assert set(res["stage_ms"][0]) == {"decode", "dispatch", "collect", "latency"}


def test_staged_equals_synchronous(image_dir):
    """The staged pipeline (PNG bytes through decode / dispatch / collect
    on the native threads) and process_frame on the main thread, each on
    a fresh pipeline with the same seed: the same poses, bit for bit."""
    cfg = dataclasses.replace(torch_parity_util.TORCH_SMALL_CFG, enable_loop_closure=False,
                              enable_mapping=False)
    pngs = [open(os.path.join(image_dir, f), "rb").read()
            for f in sorted(os.listdir(image_dir))]
    sync = factory.create_cpu(cfg)
    want = [sync.process_frame(decode_png_gray8(b), k / 10.0) for k, b in enumerate(pngs)]
    staged = factory.create_cpu(cfg)
    with async_pipeline.AsyncSlamPipeline(staged, drop_threshold=0) as ap:
        for k, b in enumerate(pngs):
            assert ap.submit(k / 10.0, raw_bytes=b)
        got = ap.drain(timeout_s=120.0)
        timings = list(ap.timings)
    assert [t for t, _ in got] == [k / 10.0 for k in range(FRAMES)]
    for (_, p), w in zip(got, want):
        np.testing.assert_array_equal(p, w)
    assert len(timings) == FRAMES and all(t["decode"] > 0 for t in timings)


def test_detect_hands_detections_to_audio(image_dir, monkeypatch, tmp_path):
    """--detect at a narrow width (tests/torch_parity_util's TINY npz,
    whose head fires on every anchor as a person): the audio engine is
    called once per processed frame with host arrays, each equal to the
    detections of that frame or of a later one (guidance reads
    pipe.last_output, as in the JAX example), and speaks."""
    npz = torch_parity_util.tiny_detector_npz(str(tmp_path / "tiny.npz"))
    tiny = DetectorConfig(input_size=64, width_mult=0.25, depth_mult=0.33)
    real_create = factory.create

    def narrow_create(*a, config=None, **kw):
        return real_create(*a, config=dataclasses.replace(config, detector=tiny),
                           detector_weights=npz, **kw)

    monkeypatch.setattr(factory, "create", narrow_create)
    seen = _record(factory, monkeypatch)
    calls = []
    real_process = NavigationAudioEngine.process_detections

    def process_detections(self, boxes, classes, valid, depths=None):
        from aria_slam_tpu_torch.utils.audio import _host

        host = _host(boxes, classes, valid)
        calls.append(host)
        return real_process(self, *host, depths)

    monkeypatch.setattr(NavigationAudioEngine, "process_detections", process_detections)
    res = nav.run(image_dir, detect=True, device="cpu", verbose=False)

    assert seen["config"].enable_detection and seen["config"].enable_dynamic_filtering
    assert res["processed"] == FRAMES and res["audio_calls"] == len(calls) == FRAMES
    frames_dets = seen["detections"][1:]  # after the warm-up
    for k, got in enumerate(calls):
        assert all(isinstance(a, np.ndarray) for a in got)
        later = [j for j in range(k, FRAMES)
                 if all(np.array_equal(a, b) for a, b in zip(got, frames_dets[j]))]
        assert later, k
    assert all(d[2].any() for d in frames_dets)
    assert res["audio_events"] >= 1


class _StubPipe:
    """process_frame gives the identity pose, or raises on the frame at
    fail_at."""

    def __init__(self, fail_at=None):
        self.fail_at = fail_at

    def process_frame(self, image, ts):
        if ts == self.fail_at:
            raise ValueError("step failed")
        return np.eye(4, dtype=np.float32)


@pytest.mark.parametrize("stage", ["decode", "dispatch", "collect"])
def test_a_stage_that_raises_fails_the_run(stage):
    """ctypes would print a callback's exception and carry on; a stage
    that raises (a corrupt PNG, a failed step, a failed on_result) makes
    drain raise it instead of returning fewer results."""
    def on_result(ts, pose):
        if stage == "collect" and ts == 2.0:
            raise ValueError("on_result failed")

    pipe = _StubPipe(2.0 if stage == "dispatch" else None)
    img = np.zeros((8, 8), np.uint8)
    with async_pipeline.AsyncSlamPipeline(pipe, drop_threshold=0, on_result=on_result) as ap:
        for k in range(4):
            if stage == "decode" and k == 2:
                assert ap.submit(float(k), raw_bytes=b"not a png")
            else:
                assert ap.submit(float(k), image=img)
        with pytest.raises(async_pipeline.StageError, match=f"the {stage} stage") as e:
            ap.drain(timeout_s=10.0)
    assert e.value.__cause__ is not None


def test_run_raises_when_dispatch_fails(image_dir, monkeypatch):
    """A step that raises on the dispatch thread fails the example's run."""
    real_create = factory.create

    def failing_create(*a, **kw):
        pipe = real_create(*a, **kw)
        step = pipe.process_frame

        def process_frame(image, ts):
            if ts > 0 and pipe.state.frame_id >= 2:
                raise RuntimeError("the card went away")
            return step(image, ts)

        pipe.process_frame = process_frame
        return pipe

    monkeypatch.setattr(factory, "create", failing_create)
    with pytest.raises(async_pipeline.StageError, match="dispatch"):
        nav.run(image_dir, device="cpu", verbose=False)


def test_runs_on_the_card_unless_asked(image_dir, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nav.run(image_dir, verbose=False)
