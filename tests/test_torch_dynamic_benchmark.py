"""The port's scene training (models/detector_train.load_scene_boxes,
resize_area, make_scene_batch, train_on_scene) and eval/dynamic_benchmark
against the JAX package on the CPU.

The reference resizes with cv2.resize(INTER_AREA), summing in float32 in
its own order; the port's resize_area takes OpenCV's weights and sums in
float64, so the two agree to about 3e-5 on the 0-255 scale (measured
1.5e-5 at 240x320, 3.1e-5 at 480x752 and 96x96), not bit for bit; a scene
batch (divided by 255) agrees to about 1.2e-7. Everything else of a batch
(the frame, flip and jitter draws, the boxes) is exact.

The full benchmark (tests/test_dynamic_filter.py: 64 frames, 800 steps)
is the JAX package's own heavyweight test; here the port's run is held
to the reference's plumbing with stubs, and runs once for real at a tiny
size on the CPU.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import cv2
import flax.traverse_util as tu
import jax.numpy as jnp

from aria_slam_tpu.eval import dynamic_benchmark as jdb
from aria_slam_tpu.models import detector_train as jdt
from aria_slam_tpu.models import yolo as jyolo
from aria_slam_tpu_torch import convert
from aria_slam_tpu_torch.config import DetectorConfig
from aria_slam_tpu_torch.eval import dynamic_benchmark as tdb
from aria_slam_tpu_torch.io import euroc, synthetic_scene
from aria_slam_tpu_torch.models import detector_train as tdt
from aria_slam_tpu_torch.models import yolo

import torch_parity_util  # noqa: F401  (two torch threads a worker)

SCENE_FRAMES = 6


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A 6-frame 320x240 moving-object sweep (the benchmark's object)."""
    d = str(tmp_path_factory.mktemp("dyn") / "scene")
    synthetic_scene.generate(d, num_frames=SCENE_FRAMES, fps=10.0, cam=tdb.SMALL_CAM,
                             depth=4.0, traj="sweep", period=10.0, moving_object=True,
                             object_size=2.2, object_speed=2.8)
    data = euroc.load(d)
    frames = [euroc.load_image(p) for p in data.image_paths]
    boxes = tdt.scene_boxes(data, tdt.load_scene_boxes(d))
    return d, frames, boxes


# ------------------------------------------------------------ the resize
@pytest.mark.parametrize("shape", [(240, 320), (480, 752), (96, 96)])
def test_resize_area_equals_opencv(shape):
    """resize_area against cv2.resize(INTER_AREA) to 160 x 160 on float32
    noise in 0-255: shrinking (OpenCV's area table) and growing (its
    linear path in area mode) within 1e-4."""
    img = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    got = tdt.resize_area(img, 160, 160)
    want = cv2.resize(img, (160, 160), interpolation=cv2.INTER_AREA)
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


# ------------------------------------------------------------ the batches
def test_load_scene_boxes_equals_reference(scene):
    d, _, boxes = scene
    assert tdt.load_scene_boxes(d) == jdt.load_scene_boxes(d)
    assert sum(b is not None for b in boxes) >= 1


@pytest.mark.parametrize("seed,batch", [(0, 8), (3, 5)])
def test_make_scene_batch_equals_reference(scene, seed, batch):
    """The same seeded rng through both packages: labels exact, images
    within 1e-6, and both generators left at the same state."""
    _, frames, boxes = scene
    rt, rj = np.random.default_rng(seed), np.random.default_rng(seed)
    got = tdt.make_scene_batch(rt, frames, boxes, batch, 160)
    want = jdt.make_scene_batch(rj, frames, boxes, batch, 160)
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-6)
    for g, w in zip(got[1:], want[1:]):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert got[3].any()
    assert rt.random() == rj.random()


def test_train_on_scene_equals_reference(scene, monkeypatch):
    """Two steps of train_on_scene (64 px, width 0.25, batch 2) in both
    packages, float32 models from the same init (the packages' bf16 step
    is tests/test_torch_train.py's), each step's inputs recorded: the
    batches equal (images within 1e-6), the losses at
    tests/test_torch_train.py's float32 tolerances (first step 1e-5,
    second 2e-3 relative) and the parameters after Adam as
    test_adam_steps_against_reference holds them (97 % within 1e-3, none
    more than 2 lr a step away)."""
    d = scene[0]
    cfg_kw = dict(input_size=64, width_mult=0.25, depth_mult=0.33, num_classes=2)
    lr = 3e-3
    seen = {"jax": [], "port": []}

    def recording(make, key):
        def wrapped(*a, **kw):
            step = make(*a, **kw)

            def run(*args):
                batch = [np.asarray(x) for x in args[-4:]]
                out = step(*args)
                seen[key].append((batch, float(out[-1] if key == "jax" else out)))
                return out
            return run
        return wrapped

    j_init = jyolo.init_params

    def init32(cfg, key=None):
        _, v = j_init(cfg, key)
        return jyolo.Yolo(cfg.num_classes, cfg.width_mult, cfg.depth_mult, dtype=jnp.float32), v

    t_init = yolo.init_model
    monkeypatch.setattr(jyolo, "init_params", init32)
    monkeypatch.setattr(yolo, "init_model", lambda cfg, seed, **kw: t_init(
        cfg, seed, dtype=torch.float32, param_dtype=torch.float32))
    monkeypatch.setattr(jdt, "make_train_step", recording(jdt.make_train_step, "jax"))
    monkeypatch.setattr(tdt, "make_train_step", recording(tdt.make_train_step, "port"))
    from aria_slam_tpu.config import DetectorConfig as JaxDetectorConfig

    variables = jdt.train_on_scene(JaxDetectorConfig(**cfg_kw), d, steps=2, batch=2, lr=lr)
    model = tdt.train_on_scene(DetectorConfig(**cfg_kw), d, steps=2, batch=2, lr=lr,
                               device="cpu")
    assert not model.training and model.dtype == torch.float32
    for i, ((bj, lj), (bt, lt)) in enumerate(zip(seen["jax"], seen["port"])):
        np.testing.assert_allclose(bt[0], bj[0], rtol=0, atol=1e-6)
        for g, w in zip(bt[1:], bj[1:]):
            np.testing.assert_array_equal(g, w)
        assert abs(lt - lj) <= (1e-5 if i == 0 else 2e-3) * lj, (i, lt, lj)
    assert len(seen["jax"]) == len(seen["port"]) == 2
    got = convert.yolo_to_flax(model)
    want = {"/".join(k): np.asarray(v) for k, v in tu.flatten_dict(variables).items()}
    assert set(got) == set(want)
    gap = np.concatenate([np.abs(got[k] - w).ravel() for k, w in want.items()
                          if k.startswith("params/")])
    assert (gap <= 1e-3).mean() >= 0.97
    assert gap.max() <= 2 * lr * 2


def test_train_on_scene_runs_on_the_card_unless_asked(scene, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tdt.train_on_scene(tdb.TINY_DET, scene[0], steps=1)


# ------------------------------------------------------------ the benchmark
STUB_REPORTS = {
    "clean": dict(frames=64, ate_rmse_m=0.1234567, ate_noscale_rmse_m=0.4212345,
                  rpe_rot_deg=0.0412345, umeyama_scale=0.9123456, loops=0,
                  stage_ms={"frontend": 1.23456}),
    "object_nofilter": dict(frames=64, ate_rmse_m=0.2345678, ate_noscale_rmse_m=0.7812345,
                            rpe_rot_deg=0.1412345, umeyama_scale=0.6187654, loops=0,
                            stage_ms={"frontend": 2.34567}),
    "object_filtered": dict(frames=64, ate_rmse_m=0.1876543, ate_noscale_rmse_m=0.5612345,
                            rpe_rot_deg=0.1912345, umeyama_scale=0.8352345, loops=0,
                            stage_ms={"frontend": 3.45678}),
}


def _stub(monkeypatch, eval_mod, scene_mod, train_mod, yolo_mod, calls):
    def generate(d, **kw):
        os.makedirs(os.path.join(d, "mav0"))
        calls.append(("generate", os.path.basename(d), dataclasses.asdict(kw.pop("cam")), kw))
        return d

    def train_on_scene(cfg, scene_dir, steps, verbose, **kw):
        calls.append(("train", dataclasses.asdict(cfg), os.path.basename(scene_dir), steps))
        return "weights"

    def save_weights(weights, path):
        assert weights == "weights"
        open(path, "w").close()

    def run(scene_dir, out_dir, config, verbose, chunk, **kw):
        cfg = dataclasses.asdict(config)
        if cfg["detector_weights"]:
            cfg["detector_weights"] = os.path.basename(cfg["detector_weights"])
        calls.append(("eval", os.path.basename(scene_dir), os.path.basename(out_dir), cfg,
                      chunk))
        return dict(STUB_REPORTS[os.path.basename(out_dir)])

    monkeypatch.setattr(scene_mod, "generate", generate)
    monkeypatch.setattr(train_mod, "train_on_scene", train_on_scene)
    monkeypatch.setattr(yolo_mod, "save_weights", save_weights)
    monkeypatch.setattr(eval_mod, "run", run)


def test_benchmark_plumbing_equals_reference(tmp_path, monkeypatch):
    """dynamic_benchmark.run in both packages with generate, train_on_scene,
    save_weights and euroc_eval.run stubbed on the same reports: the same
    calls with equal configs field by field, equal reports and verdicts,
    and a second run on the same directory neither generates nor trains."""
    from aria_slam_tpu.eval import euroc_eval as jee
    from aria_slam_tpu.io import synthetic_scene as jss
    from aria_slam_tpu_torch.eval import euroc_eval as tee

    assert dataclasses.asdict(tdb.base_config(True)) == dataclasses.asdict(jdb.base_config(True))
    out = {}
    for name, mods in (("jax", (jee, jss, jdt, jyolo)),
                       ("port", (tee, synthetic_scene, tdt, yolo))):
        calls = []
        with monkeypatch.context() as m:
            _stub(m, *mods, calls)
            kw = dict(frames=64, steps=800, chunk=16, verbose=False)
            if name == "port":
                kw["device"] = "cpu"
            report = (jdb if name == "jax" else tdb).run(str(tmp_path / name), **kw)
            n_first = len(calls)
            again = (jdb if name == "jax" else tdb).run(str(tmp_path / name), **kw)
        out[name] = (calls, report, again, n_first)
        with open(tmp_path / name / "report.json") as f:
            assert f.read()
    (cj, rj, aj, nj), (ct, rt, at, nt) = out["jax"], out["port"]
    assert ct == cj
    assert nt == nj == 6
    assert [c[0] for c in ct[nt:]] == ["eval"] * 3
    assert rt == rj and at == rt
    assert rt["verdict"]["filtering_helps"] is True
    assert rt["clean"]["ate_rmse_m"] == 0.1235


def test_benchmark_runs_on_the_cpu(tmp_path, monkeypatch):
    """One real tiny run of the port (9 frames, 2 training steps, chunk 4,
    tests/test_pipeline.py's small pose graph: the default one's final
    optimisation takes 20 s a run on the CPU) reaches its report; the JAX
    package reads the weights."""
    base = tdb.base_config
    monkeypatch.setattr(tdb, "base_config", lambda full_res=False: dataclasses.replace(
        base(full_res), pose_graph=torch_parity_util.TORCH_SMALL_CFG.pose_graph))
    report = tdb.run(str(tmp_path), frames=9, steps=2, chunk=4, verbose=False, device="cpu")
    assert set(report) == {"clean", "object_nofilter", "object_filtered", "verdict"}
    for name in ("clean", "object_nofilter", "object_filtered"):
        assert report[name]["frames"] == 9
        assert np.isfinite(report[name]["ate_rmse_m"]) and report[name]["umeyama_scale"] > 0
    assert set(report["verdict"]) == {"corruption_x", "recovery_x", "rot_corruption_x",
                                      "rot_recovery_x", "scale_err_off", "scale_err_on",
                                      "filtering_helps"}
    assert os.path.exists(tmp_path / "report.json")
    w = jyolo.load_weights(str(tmp_path / "object_detector.npz"))
    _, ref = jyolo.init_params(jdb.TINY_DET)
    assert ({k: v.shape for k, v in tu.flatten_dict(w).items()}
            == {k: v.shape for k, v in tu.flatten_dict(ref).items()})


# ------------------------------------------------------ the padded chunk
def _card_forms(monkeypatch):
    """ops/linalg.dot / matvec and ops/epipolar._apply as they run on CUDA
    tensors (a product and a sum; chip_smoke.card_forms), on the CPU."""
    from aria_slam_tpu_torch.ops import epipolar, linalg

    monkeypatch.setattr(linalg, "dot", lambda a, b: (a * b).sum(-1))
    monkeypatch.setattr(linalg, "matvec", lambda M, v: (M * v[..., None, :]).sum(-1))
    monkeypatch.setattr(epipolar, "_apply", lambda E, x: (E * x[..., None, :]).sum(-1))


@pytest.mark.parametrize("forms", ["cpu", "card"])
def test_padding_pairs_never_succeed(scene, monkeypatch, forms):
    """euroc_eval fills a sequence's last chunk by repeating its last frame
    (timestamp included). Such a pair has zero parallax, so its cheirality
    test is decided by rounding: in the card's contraction forms it
    passed, and the pair's random unit translation went into the chain
    and the chunk BA (the clean run's rotation RPE 0.13 degrees on an H100
    against 0.04 on the CPU). A pair whose two timestamps are equal
    never succeeds, in either form; the real pairs are unchanged."""
    from aria_slam_tpu_torch.eval.chunked import ChunkedSlam

    if forms == "card":
        _card_forms(monkeypatch)
    d, frames, _ = scene
    ts = euroc.load(d).image_ts
    cfg = dataclasses.replace(tdb.base_config(),
                              pose_graph=torch_parity_util.TORCH_SMALL_CFG.pose_graph)
    oks = []
    for pad in (False, True):
        slam = ChunkedSlam(cfg, chunk=4, device="cpu")
        slam.process_chunk(np.stack(frames[:5]), ts[:5])
        idx = [4, 5, 5, 5, 5] if pad else [1, 2, 3, 4, 5]
        slam.process_chunk(np.stack([frames[i] for i in idx]), ts[idx])
        oks.append(slam.last_ok)
    assert not oks[1][1:].any(), oks[1]
    assert oks[1][0] and oks[0].all()
