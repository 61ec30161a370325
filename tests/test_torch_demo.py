"""The port's video demo (eval/demo.py) on the CPU: a short video written
with OpenCV, as tests/test_components.py::test_demo_headless does, read
back through demo.run with device="cpu", against the JAX package's
demo.run on the same video with the demo's own configuration; the
per-frame body on its own (the stats line, the overlay's arrays on the
host); OpenCV required, the card unless asked."""

import dataclasses
import sys

import numpy as np
import pytest
import torch

import cv2
import jax

from aria_slam_tpu.eval import demo as jdemo
from aria_slam_tpu.pipeline import factory as jfactory
from aria_slam_tpu_torch.config import DetectorConfig
from aria_slam_tpu_torch.eval import demo
from aria_slam_tpu_torch.io import synthetic_scene
from aria_slam_tpu_torch.pipeline import factory

import torch_parity_util
from torch_parity_util import JaxChainSampler

FRAMES = 6
CFG = dataclasses.replace(torch_parity_util.TORCH_SMALL_CFG, enable_fusion=False,
                          enable_mapping=False, enable_loop_closure=False)
DETECT_CFG = dataclasses.replace(
    CFG, enable_detection=True, enable_dynamic_filtering=True,
    detector=DetectorConfig(input_size=64, width_mult=0.25, depth_mult=0.33, num_classes=2))


def _frames(n=FRAMES):
    tex = synthetic_scene._texture(512, seed=1)
    return [synthetic_scene.render_frame(CFG.camera, tex, *synthetic_scene.trajectory(k / 10.0))
            for k in range(n)]


@pytest.fixture(scope="module")
def video(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("demo") / "test.mp4")
    wr = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 10, (320, 240))
    for img in _frames():
        wr.write(cv2.cvtColor(img, cv2.COLOR_GRAY2BGR))
    wr.release()
    return path


def test_demo_headless(video):
    stats = demo.run(video, headless=True, config=CFG, device="cpu")
    assert stats["frames"] == FRAMES
    assert stats["avg_fps"] > 0


def _recorded_run(module, factory_module, video, monkeypatch, **create_kw):
    """module.run(video) headless with its default configuration, the
    pipeline that factory_module.create builds recorded: (its config,
    each frame's (pose, features, matches, inliers, success))."""
    real_create = factory_module.create
    seen = {"frames": []}

    def create(*a, **kw):
        pipe = real_create(*a, **kw, **create_kw)
        step = pipe.process_frame

        def process_frame(*fa, **fkw):
            pose = np.asarray(step(*fa, **fkw))
            o = pipe.last_output
            seen["frames"].append((pose, int(o.num_features), int(o.num_matches),
                                   int(o.num_inliers), bool(o.vo_success)))
            return pose

        pipe.process_frame = process_frame
        seen["config"] = pipe.config
        return pipe

    monkeypatch.setattr(factory_module, "create", create)
    kw = {"device": "cpu"} if module is demo else {}
    stats = module.run(video, headless=True, **kw)
    assert stats["frames"] == FRAMES
    return seen["config"], seen["frames"]


def test_demo_default_config_matches_jax(video, monkeypatch):
    """Both packages' demo.run on the same video with no config: the
    configuration each builds from the video (the camera fx = fy = 0.9 w,
    cx, cy at the centre, no distortion; detection and filtering off
    without --detect; loop closure, fusion and mapping off) is equal
    field by field, and frame by frame (the port drawing the JAX
    pipeline's RANSAC key chain) the features and matches are equal, the
    inliers within 2, the success flags equal and the poses within 2e-3,
    as tests/test_torch_online.py holds the online step."""
    jcfg, jframes = _recorded_run(jdemo, jfactory, video, monkeypatch)
    tcfg, tframes = _recorded_run(demo, factory, video, monkeypatch,
                                  sampler=JaxChainSampler(jax.random.key(0)))
    assert tcfg.to_dict() == jcfg.to_dict()
    cam = tcfg.camera
    assert (cam.width, cam.height, cam.fx, cam.fy, cam.cx, cam.cy) == (320, 240, 288.0, 288.0,
                                                                         160.0, 120.0)
    assert not (tcfg.enable_detection or tcfg.enable_dynamic_filtering
                or tcfg.enable_loop_closure or tcfg.enable_fusion or tcfg.enable_mapping)
    assert len(tframes) == len(jframes) == FRAMES
    for (jp, fj, mj, ij, okj), (tp, ft, mt, it, okt) in zip(jframes, tframes):
        assert (ft, mt, okt) == (fj, mj, okj)
        assert abs(it - ij) <= 2, (ij, it)
        np.testing.assert_allclose(tp, jp, atol=2e-3)
    assert sum(ok for *_, ok in tframes) >= FRAMES // 2


class _Built(Exception):
    pass


def test_demo_detect_config_matches_jax(video, monkeypatch):
    """--detect: both packages build the same configuration from the
    video, with detection and dynamic filtering on (the pipeline is not
    built: the create call stops the run)."""
    configs = []

    def create(*a, config=None, **kw):
        configs.append(config)
        raise _Built

    for module, factory_module in ((jdemo, jfactory), (demo, factory)):
        monkeypatch.setattr(factory_module, "create", create)
        with pytest.raises(_Built):
            module.run(video, headless=True, detect=True)
    jcfg, tcfg = configs
    assert tcfg.to_dict() == jcfg.to_dict()
    assert tcfg.enable_detection and tcfg.enable_dynamic_filtering
    assert tcfg.camera.fx == tcfg.camera.fy == 288.0


def test_demo_writes_the_overlay_with_detection(video, tmp_path):
    """--detect with --out: the detector and the dynamic filter in the
    step, keypoints and boxes drawn from the host arrays, an mp4 written."""
    out = str(tmp_path / "overlay.mp4")
    stats = demo.run(video, headless=True, detect=True, max_frames=4, out_path=out,
                     config=DETECT_CFG, device="cpu")
    assert stats["frames"] == 4
    cap = cv2.VideoCapture(out)
    n = 0
    while cap.read()[0]:
        n += 1
    cap.release()
    assert n == 4


def test_frame_step_stats_line_and_overlay(monkeypatch, capsys):
    """The per-frame body without OpenCV: the stats line at every
    STATS_EVERY-th frame, and the valid keypoints and detection boxes as
    numpy arrays on the host."""
    monkeypatch.setattr(demo, "STATS_EVERY", 3)
    pipe = factory.create(config=DETECT_CFG, device="cpu")
    fps = 0.0
    for n, img in enumerate(_frames(4)):
        pose, fps, arrays = demo.frame_step(pipe, img, n, fps, 10.0, overlay=True)
        assert pose.shape == (4, 4) and np.isfinite(pose).all() and fps > 0
        kp, boxes = arrays["keypoints"], arrays["boxes"]
        assert isinstance(kp, np.ndarray) and kp.ndim == 2 and kp.shape[1] == 2
        assert len(kp) == int(pipe.state.prev_feats.valid.sum()) > 0
        assert isinstance(boxes, np.ndarray) and boxes.shape[1:] == (4,)
        assert len(boxes) == int(pipe.last_output.detections.valid.sum())
    lines = capsys.readouterr().out.splitlines()
    assert len(lines) == 1 and lines[0].startswith("[3] fps=")
    assert demo.frame_step(pipe, img, 4, fps, 10.0)[2] is None


def test_demo_needs_opencv(video, monkeypatch):
    """Without OpenCV the demo raises the reference's ImportError; it has
    no other video reader."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError, match="needs OpenCV"):
        demo.run(video, config=CFG, device="cpu")


def test_demo_runs_on_the_card_unless_asked(video, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        demo.run(video, config=CFG)
