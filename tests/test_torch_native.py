"""The port's host runtime (on the CPU): its own build and binding of the
repository's native C++ library (aria_slam_tpu_torch/native.py; the five
tests of tests/test_native.py), the async pipeline on it, the native CSV
parser and map writers against their numpy versions (io/euroc.py,
mapping/export.py), the state snapshot (utils/snapshot.py, a JAX file
included), structured logging and the interface protocols."""

import json
import os
import time

import numpy as np
import pytest
import torch

from aria_slam_tpu_torch import native
from aria_slam_tpu_torch.io import euroc
from aria_slam_tpu_torch.mapping import export

from torch_parity_util import TORCH_SMALL_CFG


def test_csv_parse_matches_numpy(tmp_path):
    p = tmp_path / "data.csv"
    data = np.random.default_rng(0).normal(size=(500, 7))
    with open(p, "w") as f:
        f.write("#timestamp,a,b,c,d,e,f\n")
        for row in data:
            f.write(",".join(f"{v:.9f}" for v in row) + "\n")
    out = native.parse_csv(str(p), 7)
    np.testing.assert_allclose(out, data, atol=1e-9)
    np.testing.assert_array_equal(out, euroc._read_csv_numpy(str(p), 7))
    with pytest.raises(FileNotFoundError):
        native.parse_csv(str(tmp_path / "missing.csv"), 7)


def test_ply_pcd_writers(tmp_path):
    xyz = np.array([[1, 2, 3], [4, 5, 6]], np.float32)
    rgb = np.array([[255, 0, 0], [0, 255, 0]], np.uint8)
    ply, pcd = str(tmp_path / "m.ply"), str(tmp_path / "m.pcd")
    assert native.write_ply(ply, xyz, rgb) == 2
    assert native.write_pcd(pcd, xyz, rgb) == 2
    lines = open(ply).read().splitlines()
    assert lines[0] == "ply" and "element vertex 2" in lines[2]
    assert lines[-1].startswith("4.000000 5.000000 6.000000 0 255 0")
    assert "POINTS 2" in open(pcd).read()
    with pytest.raises(OSError):
        native.write_ply(str(tmp_path / "no" / "m.ply"), xyz, rgb)


def test_async_executor_pipeline_order():
    """3 stages: items pass every stage once, in order at each stage."""
    log = {0: [], 1: [], 2: []}
    ex = native.AsyncExecutor([log[s].append for s in range(3)], queue_capacity=4)
    for i in range(20):
        assert ex.submit(i)
    ex.stop()
    stats = ex.stats()
    ex.close()
    assert log[0] == log[1] == log[2] == list(range(20))
    assert stats["processed"] == [20, 20, 20]


def test_backpressure_drops_when_overloaded():
    """Frame skipping: with a slow first stage and a drop threshold, a
    burst drops frames rather than stalls."""
    ex = native.AsyncExecutor([lambda item: time.sleep(0.01)], queue_capacity=8,
                              drop_threshold=2)
    accepted = sum(ex.submit(i) for i in range(50))
    ex.stop()
    stats = ex.stats()
    ex.close()
    assert accepted < 50
    assert stats["dropped"][0] == 50 - accepted
    assert stats["processed"][0] == accepted


def test_preloader_reads_files(tmp_path):
    paths = []
    for i in range(5):
        p = tmp_path / f"f{i}.bin"
        p.write_bytes(bytes([i]) * (100 + i))
        paths.append(str(p))
    with native.Preloader(paths + [str(tmp_path / "missing.bin")]) as pre:
        for i in range(5):
            assert pre.get(i) == bytes([i]) * (100 + i)
        with pytest.raises(FileNotFoundError):
            pre.get(5)


def test_library_builds_outside_native_dir():
    """The library is built under the package's _build directory, named by
    its sources' hash; nothing is written into native/."""
    native._load()
    target = native._target()
    assert target.exists() and target.parent == native.BUILD_DIR
    assert not any(f.suffix == ".tmp" for f in native.NATIVE_DIR.rglob("*"))


def test_async_pipeline_on_mock():
    """tests/test_components.py's async test on the port: five frames
    through decode / dispatch / collect on the native executor, in order,
    finite poses; one frame arrives as PNG bytes (the port's decoder)."""
    from aria_slam_tpu_torch.pipeline import factory
    from aria_slam_tpu_torch.pipeline.async_pipeline import AsyncSlamPipeline

    pipe = factory.create_mock(TORCH_SMALL_CFG, device="cpu")
    rng = np.random.default_rng(0)
    pipe.process_frame(rng.uniform(0, 255, (240, 320)).astype(np.float32), 0.0)
    got = []
    with AsyncSlamPipeline(pipe, drop_threshold=0,
                           on_result=lambda t, p: got.append(t)) as ap:
        for k in range(1, 5):
            assert ap.submit(k * 0.1, rng.uniform(0, 255, (240, 320)).astype(np.float32))
        png = euroc.encode_png_gray8(rng.integers(0, 256, (240, 320)).astype(np.uint8))
        assert ap.submit(0.5, raw_bytes=png)
        results = ap.drain(timeout_s=60.0)
        stats = ap.stats()
    assert len(results) == 5 and stats["processed"] == [5, 5, 5]
    assert all(np.isfinite(p).all() for _, p in results)
    ts = [t for t, _ in results]
    assert ts == sorted(ts) == got


def test_euroc_reader_uses_native_parser(tmp_path):
    """The reader's CSV path (native) equals the numpy reader on an IMU
    file of the generator, and falls back to numpy for a file whose rows
    hold fewer numbers than asked."""
    from aria_slam_tpu_torch.io import synthetic_scene

    synthetic_scene.generate(str(tmp_path), num_frames=2, fps=5.0)
    imu = str(tmp_path / "mav0" / "imu0" / "data.csv")
    a = euroc._read_csv(imu, 7)
    np.testing.assert_array_equal(a, euroc._read_csv_numpy(imu, 7))
    assert a.shape == (80, 7)
    with pytest.raises(ValueError, match="columns"):
        euroc._read_csv(imu, 9)


def test_map_export_native_equals_numpy(tmp_path):
    """export_ply / export_pcd through the native writers give the same
    bytes as the numpy writers, on a map with colours at 0 and 1."""
    from aria_slam_tpu_torch.core.types import MapState

    rng = np.random.default_rng(1)
    n = 300
    cols = rng.uniform(-0.1, 1.1, (n, 3)).astype(np.float32)
    m = MapState(points=torch.from_numpy(rng.normal(0, 3, (n, 3)).astype(np.float32)),
                 colors=torch.from_numpy(cols), quality=torch.ones(n),
                 valid=torch.from_numpy(rng.random(n) < 0.8), count=torch.tensor(n))
    paths = {k: str(tmp_path / k) for k in ("a.ply", "b.ply", "a.pcd", "b.pcd")}
    n_live = int(m.valid.sum())
    assert export.export_map(m, paths["a.ply"], paths["a.pcd"]) == n_live
    pts, c = export._live_points(m)
    rgb = (c * 255).astype(np.uint8)
    assert export.write_ply_numpy(paths["b.ply"], pts, rgb) == n_live
    assert export.write_pcd_numpy(paths["b.pcd"], pts, rgb) == n_live
    for ext in ("ply", "pcd"):
        assert open(paths[f"a.{ext}"], "rb").read() == open(paths[f"b.{ext}"], "rb").read()


def test_snapshot_roundtrip_and_jax_file(tmp_path):
    """save_state / load_state round-trip a port FrameState (the EKF on the
    host, the rest on its device) and read the leaves of a JAX FrameState
    file written by the JAX package's save_state."""
    import jax

    from aria_slam_tpu.pipeline import slam_pipeline as jsp
    from aria_slam_tpu.utils import snapshot as jsnap
    from aria_slam_tpu_torch.pipeline.slam_pipeline import init_state
    from aria_slam_tpu_torch.utils import snapshot

    from torch_parity_util import JAX_SMALL_CFG

    state = init_state(TORCH_SMALL_CFG, "cpu")
    state = state.replace(frame_id=7, pose=torch.arange(16.0).reshape(4, 4),
                          prev_feats=state.prev_feats.replace(
                              desc=torch.ones_like(state.prev_feats.desc)))
    path = str(tmp_path / "s.npz")
    snapshot.save_state(state, path)
    back = snapshot.load_state(init_state(TORCH_SMALL_CFG, "cpu"), path)
    assert back.frame_id == 7 and torch.equal(back.pose, state.pose)
    assert torch.equal(back.prev_feats.desc, state.prev_feats.desc)
    assert back.prev_feats.desc.dtype == torch.int8
    jstate = jsp.init_state(JAX_SMALL_CFG, jax.random.key(0))
    jpath = str(tmp_path / "j.npz")
    jsnap.save_state(jstate.replace(frame_id=jstate.frame_id + 3), jpath)
    fromjax = snapshot.load_state(init_state(TORCH_SMALL_CFG, "cpu"), jpath)
    assert fromjax.frame_id == 3
    np.testing.assert_array_equal(fromjax.graph.node_valid.numpy(),
                                  np.asarray(jstate.graph.node_valid))
    np.testing.assert_array_equal(fromjax.db.frame_id.numpy(), np.asarray(jstate.db.frame_id))


def test_logging_and_interfaces(tmp_path):
    """MetricsEmitter writes JSON lines; the port's detector, extractor and
    matcher satisfy the interface protocols."""
    from aria_slam_tpu_torch.config import DetectorConfig
    from aria_slam_tpu_torch.models.detect import make_detector
    from aria_slam_tpu_torch.ops import match, orb
    from aria_slam_tpu_torch.pipeline import interfaces
    from aria_slam_tpu_torch.utils.logging import MetricsEmitter, get_logger

    path = str(tmp_path / "m.jsonl")
    em = MetricsEmitter(path)
    em.emit("frame", k=1, ms=2.5)
    em.close()
    rec = json.loads(open(path).read())
    assert rec["event"] == "frame" and rec["k"] == 1
    assert get_logger().name == "aria_slam_tpu_torch"
    det = make_detector(DetectorConfig(input_size=64, width_mult=0.25, max_detections=50),
                        device="cpu")
    assert isinstance(det, interfaces.ObjectDetector)
    assert isinstance(lambda img: orb.extract(img, TORCH_SMALL_CFG.orb),
                      interfaces.FeatureExtractor)
    assert isinstance(match.match, interfaces.Matcher)
    out = det(torch.zeros(48, 72))
    assert out.boxes.shape == (50, 4) and out.valid.dtype == torch.bool
    assert os.path.exists(path)
