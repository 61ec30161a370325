"""The port's item-11 and host-only modules against the JAX package (on the
CPU): the synthetic IMU, the IMU fusion benchmark, generate()'s motion
blur against OpenCV, the pin probe with the JAX probe's draws replayed,
and twins of tests/test_aux.py's audio, scene-understanding and Aria
tests fed the port's Detections (torch tensors)."""

import dataclasses
import time

import numpy as np
import pytest
import torch

import jax

from aria_slam_tpu_torch.core.types import Detections
from aria_slam_tpu_torch.models import vlm
from aria_slam_tpu_torch.utils import audio

from torch_parity_util import JaxPairsSampler


def test_circular_motion_equals_jax():
    from aria_slam_tpu.fusion import synthetic as jsyn
    from aria_slam_tpu_torch.fusion import synthetic as tsyn

    for body_frame in (True, False):
        j = jsyn.circular_motion(2.0, body_frame=body_frame)
        t = tsyn.circular_motion(2.0, body_frame=body_frame)
        for k in ("imu_t", "accel", "gyro"):
            np.testing.assert_array_equal(t[k], j[k], err_msg=k)
        tt = np.linspace(0.0, 2.0, 7)
        for k in ("gt_pos", "gt_rot", "gt_vel"):
            np.testing.assert_array_equal(t[k](tt), j[k](tt), err_msg=k)


def test_imu_benchmark_against_jax():
    """run(3 s) on the CPU: the JAX gate (mean error < 5 cm, as
    tests/test_components.py) and both errors within 1 um of the JAX
    benchmark's: the same float32 filter in another summation order, seen
    2.3e-10 m apart in the mean and 3.0e-8 m in the max."""
    from aria_slam_tpu.eval import imu_benchmark as jimu
    from aria_slam_tpu_torch.eval import imu_benchmark as timu

    got = timu.run(duration_s=3.0, verbose=False, device="cpu")
    want = jimu.run(duration_s=3.0, verbose=False)
    assert got["mean_err_m"] < 0.05
    for k in ("mean_err_m", "max_err_m"):
        assert abs(got[k] - want[k]) < 1e-6, (k, got, want)


@pytest.mark.parametrize("k", [2, 3, 5])
def test_box_blur_equals_cv2(k):
    """generate()'s motion blur against cv2.blur(img, (k, 1)) on random
    images, the borders included, and on a saturated row, every column
    held. At k = 2 a saturated sum (510 + the rounding 2) saturates to 255
    in OpenCV 5.0's vector lanes and wraps to 0 in its scalar tail (the
    columns past the last whole 16), and so it does in the port: the
    widths 53 and 330 have a tail, 320 has none."""
    import cv2

    from aria_slam_tpu_torch.io.synthetic_scene import box_blur_rows

    rng = np.random.default_rng(k)
    for shape in ((37, 53), (4, max(k, 3)), (240, 320), (240, 330)):
        img = rng.integers(0, 255, shape).astype(np.uint8)
        np.testing.assert_array_equal(box_blur_rows(img, k), cv2.blur(img, (k, 1)))
        img[0] = 255
        got, want = box_blur_rows(img, k), cv2.blur(img, (k, 1))
        np.testing.assert_array_equal(got, want)
        lanes = shape[1] // 16 * 16
        assert (got[0, :lanes] == 255).all()
        assert (got[0, lanes:] == (0 if k == 2 else 255)).all()


def test_pin_probe_against_jax(tmp_path, monkeypatch):
    """Both probes on the same 12-frame low-resolution rotloop (written
    by the JAX generator), the port fed the JAX probe's per-pair keys,
    both on the accuracy benchmark's low-resolution configuration without
    the homography rescue and the Sampson polish (the JAX probe's compile
    about halves; both paths are held against JAX elsewhere): the same
    pairs succeed and each estimator's geometric-mean and median ratios
    agree within 2 %."""
    from aria_slam_tpu.eval import accuracy_benchmark as jbench, pin_probe as jpin
    from aria_slam_tpu.io import synthetic_scene
    from aria_slam_tpu_torch.eval import accuracy_benchmark as tbench, pin_probe as tpin

    for bench in (jbench, tbench):
        def lean(full_res=False, frames=240, _make=bench.benchmark_config):
            cfg = _make(full_res, frames)
            return dataclasses.replace(cfg, ransac=dataclasses.replace(
                cfg.ransac, h_fallback=False, polish_iters=0))
        monkeypatch.setattr(bench, "benchmark_config", lean)
    frames, scene = 12, str(tmp_path / "rotloop")
    synthetic_scene.generate(scene, num_frames=frames, fps=10.0,
                             cam=jbench.benchmark_config(False, frames).camera, depth=4.0,
                             traj="rotloop", period=20.0)
    want = jpin.run(False, frames, scene, verbose=False)
    key = jax.random.wrap_key_data(jax.random.PRNGKey(0))
    got = tpin.run(False, frames, scene, verbose=False, device="cpu",
                   sampler=JaxPairsSampler(key, frames - 1, 0))
    assert got["pairs"] == want["pairs"] == frames - 1
    assert got["pairs_ok"] == want["pairs_ok"] >= frames - 2
    for name, w in want["estimators"].items():
        g = got["estimators"][name]
        assert np.isfinite(g["geomean_ratio"]) and g["log_std"] >= 0
        for stat in ("geomean_ratio", "median_ratio"):
            assert abs(g[stat] / w[stat] - 1) < 0.02, (name, stat, g, w)


# ------------------------------------------- tests/test_aux.py's twins
def _detections(boxes, classes):
    boxes = torch.as_tensor(np.asarray(boxes, np.float32))
    n = boxes.shape[0]
    return Detections(boxes=boxes, scores=torch.full((n,), 0.9),
                      classes=torch.as_tensor(np.asarray(classes), dtype=torch.int32),
                      valid=torch.ones(n, dtype=torch.bool))


def make_engine(clock):
    sink = audio.MockAudioFeedback()
    eng = audio.NavigationAudioEngine(sink, image_width=640, clock=clock)
    return sink, eng


def test_audio_direction_and_priority():
    t = [0.0]
    sink, eng = make_engine(lambda: t[0])
    det = _detections([[0, 100, 100, 300],      # left
                       [270, 100, 370, 300],    # center
                       [540, 100, 640, 300]],   # right
                      [0, 2, 16])               # person, car, dog
    events = eng.process(det, depths=[0.5, 3.0, 10.0])
    assert len(events) == 3
    by_class = {e.message.split()[0]: e for e in events}
    assert by_class["person"].direction == audio.Direction.LEFT
    assert by_class["person"].priority == audio.Priority.CRITICAL
    assert by_class["car"].direction == audio.Direction.CENTER
    assert by_class["dog"].direction == audio.Direction.RIGHT
    assert by_class["dog"].priority == audio.Priority.LOW
    assert len(sink.alerts) == 1  # critical person
    assert len(sink.beeps) == 3


def test_audio_cooldown():
    t = [0.0]
    sink, eng = make_engine(lambda: t[0])
    det = _detections([[300, 100, 400, 300]], [2])  # car @3m -> MEDIUM, cooldown 800ms
    assert len(eng.process(det, [3.0])) == 1
    t[0] = 0.4
    assert len(eng.process_detections(det.boxes, det.classes, det.valid, [3.0])) == 0
    t[0] = 1.0
    assert len(eng.process(det, [3.0])) == 1


def test_audio_non_dynamic_class_ignored():
    sink, eng = make_engine(lambda: 0.0)
    assert eng.process(_detections([[0, 0, 10, 10]], [56])) == []


def test_espeak_sink_commands_and_beep_wav():
    """The real-TTS sink through an injected runner (no espeak needed):
    the commands, and the generated stereo beep WAV panned hard left."""
    import wave

    calls = []
    sink = audio.EspeakAudioFeedback("espeak-ng", "paplay", runner=calls.append)
    sink.speak("person left", audio.Priority.MEDIUM)
    assert calls[-1][0] == "espeak-ng" and calls[-1][-1] == "person left"
    sink.play_critical_alert("stop")
    assert calls[-1][-1] == "stop" and "210" in calls[-1]  # faster speech
    sink.play_beep(-1.0, audio.Priority.HIGH)
    cmd = calls[-1]
    assert cmd[0] == "paplay"
    with wave.open(cmd[1], "rb") as w:
        assert w.getnchannels() == 2
        frames = np.frombuffer(w.readframes(w.getnframes()), np.int16).reshape(-1, 2)
    assert np.abs(frames[:, 1]).max() == 0
    assert np.abs(frames[:, 0]).max() > 1000
    sink.play_beep(-1.0, audio.Priority.HIGH)  # cached
    assert calls[-1][1] == cmd[1]


def test_create_audio_feedback_probes_host():
    sink = audio.create_audio_feedback()
    assert isinstance(sink, (audio.EspeakAudioFeedback, audio.ConsoleAudioFeedback))
    assert isinstance(audio.create_audio_feedback(prefer_real=False),
                      audio.ConsoleAudioFeedback)


def test_vlm_async_worker_drop_oldest():
    class Slow:
        def describe(self, image, detections=None):
            time.sleep(0.05)
            return f"mean={float(np.mean(image)):.0f}"

    w = vlm.AsyncSceneWorker(Slow())
    try:
        for k in range(10):  # floods the queue; old frames dropped
            w.submit(k * 0.03, np.full((4, 4), k * 10.0))
        deadline = time.time() + 2.0
        while w.latest() is None and time.time() < deadline:
            time.sleep(0.01)
        assert w.latest() is not None
        assert w.latest().latency_s >= 0.05
    finally:
        w.close()


def test_vlm_mock_description():
    m = vlm.MockSceneUnderstanding()
    assert "bright" in m.describe(np.full((8, 8), 200.0))
    det = _detections([[0, 0, 10, 10], [5, 5, 20, 20]], [0, 2])
    det.valid[1] = False
    assert m.describe(torch.full((8, 8), 50.0), det) == "dim scene, 1 objects detected"


def test_mock_aria_device_streams(tmp_path):
    from aria_slam_tpu_torch.io.aria import MockAriaDevice
    from aria_slam_tpu_torch.io.euroc import encode_png_gray8

    for k in range(3):
        (tmp_path / f"{k}.png").write_bytes(encode_png_gray8(np.full((32, 32), k * 40, np.uint8)))
    dev = MockAriaDevice(str(tmp_path), interval_s=0.01, imu_hz=100.0)
    frames, imu = [], []
    dev.set_image_callback(lambda ts, img, cam: frames.append((ts, img.mean(), cam)))
    dev.set_imu_callback(lambda ts, a, g: imu.append(ts))
    assert dev.connect()
    assert dev.get_calibration("slam-left").width == 32
    dev.start_streaming()
    deadline = time.time() + 2.0
    while len(frames) < 3 and time.time() < deadline:
        dev.spin_once()
    dev.stop_streaming()
    assert [f[1] for f in frames] == [0.0, 40.0, 80.0]
    assert frames[0][2] == "slam-left"
    assert len(imu) > 0
