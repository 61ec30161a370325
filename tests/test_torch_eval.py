"""The port's evaluation entry point and what it stands on (on the CPU),
against the JAX package and OpenCV / PyYAML where the reference uses
them: the PNG decoder, the sensor.yaml parser, the EuRoC reader, the
scene generator, the metrics, the offline EKF with and without its RTS
smoother, and euroc_eval.run in chunk mode on one scene read by both
packages, the port drawing the JAX run's samples."""

import functools
import os
import shutil
import struct
import zlib

import cv2
import numpy as np
import pytest
import torch
import yaml

import jax
import jax.numpy as jnp

from aria_slam_tpu import config as jcfg
from aria_slam_tpu.eval import chunked as jchunked
from aria_slam_tpu.eval import euroc_eval as jeval
from aria_slam_tpu.eval import metrics as jmetrics
from aria_slam_tpu.fusion import ekf as jekf
from aria_slam_tpu.io import euroc as jeuroc
from aria_slam_tpu.io import synthetic_scene as jsynth
from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch import convert
from aria_slam_tpu_torch.eval import euroc_eval as teval
from aria_slam_tpu_torch.eval import metrics as tmetrics
from aria_slam_tpu_torch.fusion import ekf as tekf
from aria_slam_tpu_torch.io import euroc as teuroc
from aria_slam_tpu_torch.io import synthetic_scene as tsynth

from torch_parity_util import JaxChunkChainSampler, small_config

CAM_KW = dict(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
              k1=0.0, k2=0.0, p1=0.0, p2=0.0)
# the scene of tests/test_torch_loop.py: a 4 s sweep at 5 fps, frame 20
# revisits frame 10; 21 frames in 4 chunks of 5 (the last padded)
SCENE = dict(num_frames=21, fps=5.0, period=4.0, depth=4.0, traj="sweep")
CHUNK = 5
SEED = 2       # both packages take the same RANSAC branch at every pair
BAD_FRAME = 7  # made unreadable in the end-to-end scene

EUROC_SENSOR_YAML = """\
# General sensor definitions.
sensor_type: camera
comment: VI-Sensor cam0 (MT9M034)

# Sensor extrinsics wrt. the body-frame.
T_BS:
  cols: 4
  rows: 4
  data: [0.0148655429818, -0.999880929698, 0.00414029679422, -0.0216401454975,
         0.999557249008, 0.0149672133247, 0.025715529948, -0.064676986768,
        -0.0257744366974, 0.00375618835797, 0.999660727178, 0.00981073058949,
         0.0, 0.0, 0.0, 1.0]

# Camera specific definitions.
rate_hz: 20
resolution: [752, 480]
camera_model: pinhole
intrinsics: [458.654, 457.296, 367.215, 248.375] #fu, fv, cu, cv
distortion_model: radial-tangential
distortion_coefficients: [-0.28340811, 0.07395907, 0.00019359, 1.76187114e-05]
"""


def _eval_cfg(module, **kw):
    """The small configuration with loop closure (tests/test_torch_loop.py's
    gates and 16-slot ring), mapping and fusion on."""
    return small_config(
        module, enable_loop_closure=True, enable_mapping=True, enable_fusion=True,
        mapper=module.MapperConfig(max_points=5000),
        pose_graph=module.PoseGraphConfig(max_nodes=64, max_edges=128, lm_iterations=5,
                                          cg_iterations=24, final_lm_iterations=10),
        loop=module.LoopClosureConfig(max_keyframes=16, min_frames_between=10,
                                      min_score=0.3, min_matches=40), **kw)


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """The scene written by the JAX generator (OpenCV PNGs)."""
    out = str(tmp_path_factory.mktemp("jax_scene"))
    jsynth.generate(out, cam=jcfg.CameraConfig(**CAM_KW), **SCENE)
    return out


# ------------------------------------------------------------------- PNG
def _png(img, filters) -> bytes:
    """An 8-bit greyscale PNG with the given row filter a row (0 None,
    1 Sub, 2 Up, 3 Average, 4 Paeth), in two IDAT chunks."""
    x = img.astype(np.int16)
    h, w = img.shape
    rows = []
    for r in range(h):
        a = np.concatenate([[0], x[r, :-1]])
        b = x[r - 1] if r else np.zeros(w, np.int16)
        c = np.concatenate([[0], b[:-1]])
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        pred = [0 * a, a, b, (a + b) >> 1,
                np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))][filters[r]]
        rows.append(np.concatenate([[filters[r]], (x[r] - pred) & 255]).astype(np.uint8))
    data = zlib.compress(np.stack(rows).tobytes())

    def chunk(kind, body):
        return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", zlib.crc32(kind + body))

    half = len(data) // 2
    return (teuroc.PNG_SIGNATURE + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 0, 0, 0, 0))
            + chunk(b"IDAT", data[:half]) + chunk(b"IDAT", data[half:]) + chunk(b"IEND", b""))


def _test_image(seed=0, shape=(61, 83)):
    """Noise, flat runs and ramps: every filter's predictor gets work."""
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape).astype(np.uint8)
    img[10:20] = np.arange(shape[1]) * 3 % 256
    img[30:40, 20:60] = 200
    return img


@pytest.mark.parametrize("filters", ["0", "1", "2", "3", "4", "mixed", "mixed_flat"])
def test_png_filters_decode_as_opencv(tmp_path, filters):
    """A PNG written with each row filter, all five mixed (the walk) and
    None / Sub / Up mixed (the flat path, with runs of Up rows) decodes to
    the image, exactly as cv2.imread decodes it."""
    img = _test_image()
    rng = np.random.default_rng(1)
    ft = (rng.integers(0, 5, img.shape[0]) if filters == "mixed"
          else rng.integers(0, 3, img.shape[0]) if filters == "mixed_flat"
          else np.full(img.shape[0], int(filters)))
    path = str(tmp_path / "f.png")
    with open(path, "wb") as f:
        f.write(_png(img, ft))
    got = teuroc.load_image(path)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(got, cv2.imread(path, cv2.IMREAD_GRAYSCALE))


def test_png_opencv_files_and_unreadable_ones(tmp_path):
    """PNGs that cv2.imwrite writes (default, strongest compression,
    filtered strategy) decode as cv2.imread decodes them; the port's own
    writer round-trips. A missing file, a truncated one, a bad checksum,
    a non-PNG and a colour PNG are unreadable: load_image raises,
    load_image_safe gives None."""
    img = _test_image(2, (48, 64))
    for k, params in enumerate(([], [cv2.IMWRITE_PNG_COMPRESSION, 9],
                                [cv2.IMWRITE_PNG_STRATEGY, cv2.IMWRITE_PNG_STRATEGY_FILTERED])):
        path = str(tmp_path / f"cv{k}.png")
        cv2.imwrite(path, img, params)
        np.testing.assert_array_equal(teuroc.load_image(path),
                                      cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    for adaptive in (True, False):  # own.png is the filter-0 file
        own = str(tmp_path / "own.png")
        with open(own, "wb") as f:
            f.write(teuroc.encode_png_gray8(img, adaptive=adaptive))
        np.testing.assert_array_equal(cv2.imread(own, cv2.IMREAD_GRAYSCALE), img)
        np.testing.assert_array_equal(teuroc.load_image(own), img)
    good = open(own, "rb").read()
    bad = {"truncated": good[:len(good) // 2], "garbage": b"not an image at all",
           "checksum": good[:40] + bytes([good[40] ^ 1]) + good[41:]}
    cv2.imwrite(str(tmp_path / "colour.png"), np.stack([img] * 3, -1))
    for name, data in bad.items():
        with open(tmp_path / f"{name}.png", "wb") as f:
            f.write(data)
    for name in (*bad, "colour"):
        path = str(tmp_path / f"{name}.png")
        assert teuroc.load_image_safe(path) is None, name
        with pytest.raises((ValueError, zlib.error)):
            teuroc.load_image(path)
    assert teuroc.load_image_safe(str(tmp_path / "missing.png")) is None
    with pytest.raises(FileNotFoundError):
        teuroc.load_image(str(tmp_path / "missing.png"))


def test_png_batch_decodes_as_opencv(tmp_path):
    """load_images_safe, the decode worker's call, on one batch: images
    that take the walk, the flat path and another size, a colour PNG and
    a missing file, each as cv2.imread reads it (None for the last two);
    libpng's own filter choice (cv2.imwrite) among them."""
    rng = np.random.default_rng(4)
    paths = []
    for k, ft_hi in enumerate((5, 3, 5, 1, 5)):
        img = _test_image(10 + k)
        path = str(tmp_path / f"b{k}.png")
        with open(path, "wb") as f:
            f.write(_png(img, rng.integers(0, ft_hi, img.shape[0])))
        paths.append(path)
    paths.append(str(tmp_path / "small.png"))
    cv2.imwrite(paths[-1], _test_image(20, (17, 29)))
    paths.append(str(tmp_path / "libpng.png"))
    cv2.imwrite(paths[-1], _test_image(21))
    paths.append(str(tmp_path / "colour.png"))
    cv2.imwrite(paths[-1], np.stack([_test_image(22)] * 3, -1))
    paths.append(str(tmp_path / "missing.png"))
    got = teuroc.load_images_safe(paths)
    for path, img in zip(paths[:-2], got):
        np.testing.assert_array_equal(img, cv2.imread(path, cv2.IMREAD_GRAYSCALE))
    assert got[-2] is None and got[-1] is None


# ----------------------------------------------------------- sensor.yaml
def test_sensor_yaml_parser_matches_pyyaml(scene, tmp_path):
    """The port's parser against yaml.safe_load on the generator's file and
    on a EuRoC cam0 file (T_BS as a block with a list over four lines,
    comments): the keys the reader uses, equal as numbers; and the camera
    and the extrinsic the two readers build from them."""
    gen = os.path.join(scene, "mav0", "cam0", "sensor.yaml")
    euroc_yaml = tmp_path / "sensor.yaml"
    euroc_yaml.write_text(EUROC_SENSOR_YAML)
    flat = tmp_path / "flat.yaml"
    flat.write_text("T_BS: [0, 1, 0, 0, -1, 0, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1]\n")
    for path in (gen, str(euroc_yaml), str(flat)):
        text = open(path).read()
        ours, ref = teuroc.parse_sensor_yaml(text), yaml.safe_load(text)
        assert set(ours) == set(ref), path
        for key in ("intrinsics", "distortion_coefficients", "resolution"):
            if key in ref:
                np.testing.assert_array_equal(np.asarray(ours[key], float),
                                              np.asarray(ref[key], float))
        if "T_BS" in ref:
            r, o = ref["T_BS"], ours["T_BS"]
            np.testing.assert_array_equal(np.asarray(o["data"] if isinstance(o, dict) else o,
                                                     float),
                                          np.asarray(r["data"] if isinstance(r, dict) else r,
                                                     float))
        assert teuroc._load_camera(path) == tcfg.CameraConfig(
            **{f: getattr(jeuroc._load_camera(path), f) for f in CAM_KW})
        np.testing.assert_array_equal(teuroc._load_cam_extrinsic(path),
                                      jeuroc._load_cam_extrinsic(path))
    assert not np.allclose(teuroc._load_cam_extrinsic(str(euroc_yaml)), np.eye(3))


# ------------------------------------------------------- reader, writer
def test_load_matches_jax_reader(scene):
    """load() on the JAX-generated ASL directory: every field as the JAX
    reader's (timestamps, paths, IMU, ground truth, the camera, the
    extrinsic) exactly; frames decode as cv2.imread decodes them;
    imu_window and interpolate_gt as the JAX functions."""
    t, j = teuroc.load(scene), jeuroc.load(scene)
    assert t.image_paths == j.image_paths
    for name in ("image_ts", "imu_ts", "imu_gyro", "imu_accel", "gt_ts", "gt_pos", "gt_quat",
                 "R_cam_imu"):
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), err_msg=name)
    assert t.camera == tcfg.CameraConfig(**CAM_KW) and j.camera == jcfg.CameraConfig(**CAM_KW)
    for i in (0, 11, 20):
        np.testing.assert_array_equal(teuroc.load_image(t.image_paths[i]),
                                      jeuroc.load_image(j.image_paths[i]))
    for a, b in zip(teuroc.imu_window(t, 0.4, 1.0), jeuroc.imu_window(j, 0.4, 1.0)):
        np.testing.assert_array_equal(a, b)
    for tt in (t.gt_ts[0] - 1, t.gt_ts[3], t.gt_ts[3] + 0.0021, t.gt_ts[-1]):
        got, want = teuroc.interpolate_gt(t, tt), jeuroc.interpolate_gt(j, tt)
        assert (got is None) == (want is None)
        if got is not None:
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def _csv(path):
    return np.loadtxt(path, delimiter=",", comments="#", ndmin=2)


def test_generate_matches_jax_generator(scene, tmp_path, monkeypatch):
    """The port's generate() against the JAX generator, same arguments: the
    file list, data.csv and sensor.yaml identical, the IMU and ground
    truth CSVs within 1e-9, and each frame within the renderer tolerance
    of tests/test_torch_ops.py (99 % of pixels within one grey level,
    mean difference < 0.3). Its PNGs read back with cv2.imread. Four
    frames with the photometric stressors (motion blur, exposure drift,
    sensor noise) rendered by the JAX renderer are identical to the JAX
    generator's (the occluder is held against the JAX generator in
    tests/test_torch_drivers.py, the moving object in
    tests/test_torch_dynamic.py)."""
    out = str(tmp_path / "port_scene")
    tsynth.generate(out, cam=tcfg.CameraConfig(**CAM_KW), **SCENE)
    for d in ("cam0/data", "imu0", "state_groundtruth_estimate0"):
        assert sorted(os.listdir(os.path.join(out, "mav0", d))) == sorted(
            os.listdir(os.path.join(scene, "mav0", d))), d
    for f in ("cam0/data.csv", "cam0/sensor.yaml"):
        assert open(os.path.join(out, "mav0", f)).read() == open(
            os.path.join(scene, "mav0", f)).read(), f
    for f in ("imu0/data.csv", "state_groundtruth_estimate0/data.csv"):
        a, b = _csv(os.path.join(out, "mav0", f)), _csv(os.path.join(scene, "mav0", f))
        assert a.shape == b.shape
        np.testing.assert_array_equal(a[:, 0], b[:, 0])
        np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=0, atol=1e-9, err_msg=f)
    for name in sorted(os.listdir(os.path.join(out, "mav0", "cam0", "data"))):
        ours = cv2.imread(os.path.join(out, "mav0", "cam0", "data", name), cv2.IMREAD_GRAYSCALE)
        ref = cv2.imread(os.path.join(scene, "mav0", "cam0", "data", name), cv2.IMREAD_GRAYSCALE)
        diff = np.abs(ours.astype(int) - ref.astype(int))
        assert (diff <= 1).mean() >= 0.99 and diff.mean() < 0.3, (name, diff.mean())
    # the photometric stressors of tests/test_robustness.py (blur, drift,
    # noise), same arguments in both packages; with the JAX package's
    # (OpenCV) renderer under the port's generator, so that only the
    # stressors differ, every stressed frame is identical
    kw = dict(SCENE, num_frames=4, noise_std=6.0, exposure_drift=0.3, motion_blur=3)
    ours, ref = str(tmp_path / "port_stress"), str(tmp_path / "jax_stress")
    monkeypatch.setattr(tsynth, "render_frame", jsynth.render_frame)
    tsynth.generate(ours, cam=tcfg.CameraConfig(**CAM_KW), **kw)
    jsynth.generate(ref, cam=jcfg.CameraConfig(**CAM_KW), **kw)
    names = sorted(os.listdir(os.path.join(ref, "mav0", "cam0", "data")))
    assert sorted(os.listdir(os.path.join(ours, "mav0", "cam0", "data"))) == names
    for name in names:
        a, b = (cv2.imread(os.path.join(d, "mav0", "cam0", "data", name), cv2.IMREAD_GRAYSCALE)
                for d in (ours, ref))
        np.testing.assert_array_equal(a, b, err_msg=name)


# --------------------------------------------------------------- metrics
def test_metrics_match_jax_exactly(scene):
    """rpe_rmse, quat_to_mat_np and associate_and_score (all float64 numpy)
    against the JAX functions: equal to the last bit, on a noisy
    estimate of the scene's ground truth, with a rotated body frame, and
    on estimates that partly fall outside the ground truth's time range."""
    rng = np.random.default_rng(5)
    t, j = teuroc.load(scene), jeuroc.load(scene)
    R_ci = jmetrics.quat_to_mat_np(np.array([0.9, 0.1, -0.3, 0.2]) / np.linalg.norm(
        [0.9, 0.1, -0.3, 0.2]))
    t.R_cam_imu = j.R_cam_imu = R_ci
    est_ts = np.concatenate([[t.gt_ts[0] - 0.5], t.image_ts[1:], [t.gt_ts[-1] + 1.0]])
    est_T = np.tile(np.eye(4), (len(est_ts), 1, 1))
    est_T[:, :3, 3] = rng.normal(0, 1, (len(est_ts), 3))
    est_T[:, :3, :3] = jmetrics.quat_to_mat_np(rng.normal(size=(len(est_ts), 4)) / 2.0 + [1, 0, 0, 0])
    q = rng.normal(size=(7, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    np.testing.assert_array_equal(tmetrics.quat_to_mat_np(q), jmetrics.quat_to_mat_np(q))
    a, b = rng.normal(size=(30, 3)), rng.normal(size=(30, 3))
    assert tmetrics.rpe_rmse(a, b) == jmetrics.rpe_rmse(a, b)
    assert np.isnan(tmetrics.rpe_rmse(a[:5], b[:5]))
    (ts_, tg, tk), (js_, jg, jk) = (tmetrics.associate_and_score(t, est_ts, est_T),
                                    jmetrics.associate_and_score(j, est_ts, est_T))
    assert ts_ == js_ and tk == jk and len(tk) == len(est_ts) - 2
    np.testing.assert_array_equal(tg, jg)
    assert set(ts_) == {"ate_rmse_m", "ate_raw_rmse_m", "rpe_rmse_m", "rpe_rot_deg",
                        "umeyama_scale", "ate_noscale_rmse_m"}


# ------------------------------------------------------------------- EKF
def _stream(seconds=20.0, vo_start=1.0513):
    """A 200 Hz IMU stream and a 10 fps VO stream of a smooth motion with
    noise, float32, the VO starting after the IMU (vo_start s), and a
    third of the VO timestamps equal to IMU timestamps."""
    rng = np.random.default_rng(7)
    imu_t = (np.arange(1, int(seconds * 200) + 1) / 200).astype(np.float32)
    vo_t = (vo_start + np.arange(int((seconds - vo_start) * 10)) / 10).astype(np.float32)
    vo_t[::3] = imu_t[np.searchsorted(imu_t, vo_t[::3])]  # equal timestamps
    vo_t.sort()
    acc = rng.normal(0, 0.05, (len(imu_t), 3)) + [0.0, 0.0, 9.81]
    acc[:, 0] += 0.1 * np.sin(imu_t)
    acc = acc.astype(np.float32)
    gyr = (rng.normal(0, 0.002, (len(imu_t), 3)) + [0.0, 0.05, 0.0]).astype(np.float32)
    ang = 0.05 * vo_t
    vo_R = np.zeros((len(vo_t), 3, 3), np.float32)
    vo_R[:, 0, 0] = vo_R[:, 2, 2] = np.cos(ang)
    vo_R[:, 0, 2], vo_R[:, 2, 0], vo_R[:, 1, 1] = np.sin(ang), -np.sin(ang), 1.0
    vo_p = np.stack([0.1 * (1 - np.cos(vo_t)), 0.02 * vo_t, 0.0 * vo_t], -1)
    vo_p = (vo_p + rng.normal(0, 0.01, vo_p.shape)).astype(np.float32)
    return imu_t, acc, gyr, vo_t, vo_R, vo_p


@pytest.fixture(scope="module")
def ekf_runs():
    """Both packages over the 20 s stream, with and without the smoother."""
    s = _stream()
    assert len(np.intersect1d(s[0], s[3])) >= 60 and s[3][0] > s[0][0]
    cfg_j, cfg_t = jcfg.EkfConfig(), tcfg.EkfConfig()
    out = {}
    for smooth in (False, True):
        jp, jq = jax.jit(functools.partial(jekf.run_sequence, cfg=cfg_j, smooth=smooth))(
            *(jnp.asarray(a) for a in s))
        tp, tq = tekf.run_sequence(*s, cfg_t, smooth=smooth, device="cpu")
        out[smooth] = (np.asarray(jp), np.asarray(jq), tp.numpy(), tq.numpy())
    return s, out


@pytest.mark.parametrize("smooth", [False, True])
def test_run_sequence_matches_jax(ekf_runs, smooth):
    """run_sequence over a 20 s stream (4000 IMU samples, 189 VO poses, 63
    of them at an IMU sample's timestamp, the VO starting 1.05 s after
    the IMU) against the JAX scan, float32 on both sides: the forward
    filter's positions within 1e-5 m and quaternions within 2e-6, the
    smoother's within 1e-4 m and 2e-5 (measured 6.6e-7 m / 2.4e-7 and
    5.9e-6 m / 1.8e-6: float32 rounding of the matrix products over
    4,189 events, larger where the smoother's gains come from one batched
    Cholesky solve)."""
    jp, jq, tp, tq = ekf_runs[1][smooth]
    tol_p, tol_q = (1e-4, 2e-5) if smooth else (1e-5, 2e-6)
    assert np.isfinite(tp).all() and tp.shape == jp.shape
    np.testing.assert_allclose(tp, jp, atol=tol_p)
    np.testing.assert_allclose(tq, jq, atol=tol_q)
    if smooth:  # the smoother moved the track
        assert np.abs(tp - ekf_runs[1][False][2]).max() > 10 * tol_p


def test_merge_order_and_output_scatter(ekf_runs):
    """The merged event order is the JAX package's (IMU before VO at equal
    timestamps) exactly; the VO rows land at their slots through a
    scratch row for the IMU rows (no negative index), with no read on
    the host (the scatter runs on meta tensors, which have no data); an
    unsorted host stream is refused."""
    imu_t, _, _, vo_t, _, _ = ekf_runs[0]
    m, v = len(imu_t), len(vo_t)
    order = tekf.merge_order(torch.from_numpy(imu_t), torch.from_numpy(vo_t)).numpy()
    tags = np.r_[np.zeros(m), np.ones(v)]
    ref = np.argsort(np.r_[imu_t, vo_t], kind="stable")  # IMU first at ties
    np.testing.assert_array_equal(order, ref)
    assert (np.diff(np.r_[imu_t, vo_t][order]) >= 0).all()
    slot = np.r_[np.full(m, v), np.arange(v)][order]
    hist = np.arange(m + v, dtype=np.float32)[:, None] * [1.0, 2.0, 3.0]
    rows = tekf.vo_rows(torch.from_numpy(hist.astype(np.float32)), torch.from_numpy(slot), v)
    np.testing.assert_array_equal(rows.numpy(), hist[np.flatnonzero(tags[order] == 1)])
    meta = tekf.vo_rows(torch.zeros((m + v, 3), device="meta"),
                        torch.zeros(m + v, dtype=torch.int64, device="meta"), v)
    assert meta.shape == (v, 3)
    with pytest.raises(ValueError, match="not sorted"):
        tekf.run_sequence(imu_t[::-1].copy(), *ekf_runs[0][1:], tcfg.EkfConfig(), device="cpu")


def test_ekf_cores_from_a_jax_state():
    """_predict_core and _update_core one step from the same EkfState
    (convert.ekf_state_from_numpy): states, F, dx and the init flag within
    1e-6, across a gated step (dt > max_dt), a running one and an
    update."""
    cfg_j, cfg_t = jcfg.EkfConfig(), tcfg.EkfConfig()
    s = jekf.init_state()
    s = jekf.update(s, jnp.eye(3), jnp.array([0.1, 0.2, 0.0]), jnp.asarray(0.0), cfg_j)
    R = np.array([[0.99, -0.1, 0], [0.1, 0.99, 0], [0, 0, 1]], np.float32)
    R /= np.linalg.norm(R, axis=0)
    steps = [("p", 0.5), ("p", 0.505), ("p", 0.51), ("u", 0.51)]
    for kind, t in steps:
        ts = convert.ekf_state_from_numpy(jax.tree_util.tree_map(np.asarray, s), "cpu")
        if kind == "p":
            a, w = np.array([0.1, -0.2, 9.7], np.float32), np.array([0.01, 0.03, -0.02], np.float32)
            s, F = jekf._predict_core(s, jnp.float32(t), jnp.asarray(a), jnp.asarray(w), cfg_j)
            got, gF = tekf._predict_core(ts, torch.tensor(t), torch.from_numpy(a),
                                         torch.from_numpy(w), cfg_t)
            np.testing.assert_allclose(gF.numpy(), np.asarray(F), atol=1e-6)
        else:
            p = np.array([0.12, 0.21, 0.01], np.float32)
            s, dx, init = jekf._update_core(s, jnp.asarray(R), jnp.asarray(p), jnp.float32(t), cfg_j)
            got, gdx, ginit = tekf._update_core(ts, torch.from_numpy(R), torch.from_numpy(p),
                                                torch.tensor(t), cfg_t)
            np.testing.assert_allclose(gdx.numpy(), np.asarray(dx), atol=1e-6)
            assert bool(ginit) == bool(init)
        for f in ("pos", "vel", "quat", "ba", "bg", "P", "last_imu_t", "initialized"):
            np.testing.assert_allclose(np.asarray(getattr(got, f), dtype=float),
                                       np.asarray(getattr(s, f), dtype=float), atol=1e-6,
                                       err_msg=f"{kind} {t} {f}")


# ---------------------------------------------------------- end to end
@pytest.fixture(scope="module")
def eval_runs(scene, tmp_path_factory):
    """euroc_eval.run at chunk 5 on the scene, frame BAD_FRAME made
    unreadable, through both packages (the JAX evaluator seeded SEED, the
    port drawing its samples)."""
    d = tmp_path_factory.mktemp("e2e")
    src = str(d / "scene")
    shutil.copytree(scene, src)
    bad = jeuroc.load(src).image_paths[BAD_FRAME]
    with open(bad, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n broken")
    mp = pytest.MonkeyPatch()
    mp.setattr(jchunked, "ChunkedSlam", functools.partial(jchunked.ChunkedSlam, seed=SEED))
    try:
        jres = jeval.run(src, out_dir=str(d / "jax"), config=_eval_cfg(jcfg), verbose=False,
                         chunk=CHUNK, keep_pipe=True)
    finally:
        mp.undo()
    lag = jres["_pipe"].lag
    tres = teval.run(src, out_dir=str(d / "port"), config=_eval_cfg(tcfg), verbose=False,
                     chunk=CHUNK, keep_pipe=True, device="cpu",
                     sampler=JaxChunkChainSampler(jax.random.key(SEED), lag))
    return jres, tres, d


def test_euroc_eval_chunk_mode_matches_jax(eval_runs):
    """The same result keys; frames, loops and skipped images equal (the
    unreadable frame substituted, not fatal); loop pairs equal; map points
    within 2 % (the map of tests/test_torch_mapping.py follows the poses);
    Sim3, rigid and raw ATE and the three fused ATEs within 0.05 m of the
    JAX run's (the trajectories agree to 2 % of the path, as in
    tests/test_torch_chunked.py; the largest difference measured is
    0.0245 m, the fused rigid ATE's) and the Umeyama scale within 5 %; the
    stage record complete."""
    jres, tres, _ = eval_runs
    public = {k for k in jres if not k.startswith("_")}
    assert public == {k for k in tres if not k.startswith("_")}
    for k in ("frames", "loops", "skipped_images"):
        assert tres[k] == jres[k], k
    assert tres["skipped_images"] == 1 and tres["loops"] >= 1
    assert tres["_pipe"].loop_pairs == jres["_pipe"].loop_pairs
    assert abs(tres["map_points"] - jres["map_points"]) <= 0.02 * jres["map_points"]
    for k in ("ate_rmse_m", "ate_noscale_rmse_m", "ate_raw_rmse_m", "ate_fused_rmse_m",
              "ate_fused_noscale_rmse_m", "ate_fused_raw_rmse_m"):
        print(f"{k}: port {tres[k]:.4f} m, JAX {jres[k]:.4f} m")
        assert np.isfinite(tres[k]) and abs(tres[k] - jres[k]) < 0.05, (k, tres[k], jres[k])
    assert abs(np.log(tres["umeyama_scale"] / jres["umeyama_scale"])) < 0.05  # measured 2.1 %
    assert tres["rpe_rot_deg"] < 1.0
    for key in ("stage_ms", "stage_ms_p50", "stage_ms_warm", "stage_ms_steady_total", "stage_n"):
        assert {"decode", "frontend", "device_chunk", "ekf_forward", "ekf_smoother",
                "state_update"} <= set(tres[key]), key
    assert tres["stage_n"]["device_chunk"] == 4 and tres["compile_wall_s"] > 0


def test_euroc_eval_writes_its_files(eval_runs):
    """estimated_trajectory.txt and fused_trajectory.txt hold one line a
    frame like the JAX run's (timestamps equal), and map.ply / map.pcd
    hold map_points points."""
    jres, tres, d = eval_runs
    for name in ("estimated_trajectory.txt", "fused_trajectory.txt"):
        t = np.loadtxt(d / "port" / name)
        j = np.loadtxt(d / "jax" / name)
        assert t.shape == j.shape == (tres["frames"], 4), name
        np.testing.assert_array_equal(t[:, 0], j[:, 0])
    ply = (d / "port" / "map.ply").read_text().splitlines()
    assert f"element vertex {tres['map_points']}" in ply
    assert len(ply) == ply.index("end_header") + 1 + tres["map_points"]
    assert f"POINTS {tres['map_points']}" in (d / "port" / "map.pcd").read_text()


def test_online_mode_runs_vo_only_and_raises_for_the_rest(scene, tmp_path):
    """chunk = 0 builds the port's SlamPipeline: VO only runs (empty map
    files, no fused track). The online mode with every feature on is held
    against the JAX run in tests/test_torch_drivers.py."""
    cfg = small_config(tcfg)
    res = teval.run(scene, out_dir=str(tmp_path), config=cfg, verbose=False, chunk=0,
                    max_frames=4, device="cpu")
    assert res["frames"] == 4 and res["map_points"] == 0 and res["loops"] == 0
    assert np.isfinite(res["ate_rmse_m"]) and "ate_fused_rmse_m" not in res
