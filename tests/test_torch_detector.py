"""The port's detector (models/yolo.py, models/detect.py, ops/boxes.py,
ops/topk.py, convert.yolo_from_flax) against the JAX package's on the CPU:
the model on the same .npz weights (written by the JAX yolo.save_weights)
in float32 and in bfloat16, the DFL decode, the postprocess with and
without NMS (the tail of gated-out anchors included), NMS, the dynamic-box
filter, the batched detector, and the weight file's contracts. TINY
width only (64 px input, width 0.25)."""

import os

import numpy as np
import pytest
import torch

import flax.traverse_util as tu
import jax
import jax.numpy as jnp

from aria_slam_tpu.config import DetectorConfig as JaxDetectorConfig
from aria_slam_tpu.core.types import Detections as JaxDetections
from aria_slam_tpu.models import detect as jdetect
from aria_slam_tpu.models import yolo as jyolo
from aria_slam_tpu.ops import boxes as jboxes
from aria_slam_tpu_torch import convert
from aria_slam_tpu_torch.config import DetectorConfig
from aria_slam_tpu_torch.core.types import Detections
from aria_slam_tpu_torch.models import detect, yolo
from aria_slam_tpu_torch.ops import boxes
from aria_slam_tpu_torch.ops.topk import top_k_stable

from torch_parity_util import tiny_detector_npz

TINY_KW = dict(input_size=64, width_mult=0.25, depth_mult=0.33, max_detections=50)
JTINY = JaxDetectorConfig(**TINY_KW)
TINY = DetectorConfig(**TINY_KW)

# bfloat16: one rounding is 2^-8 of a value; the two frameworks sum a
# convolution in other orders and round after every layer, so a logit
# may move by a few roundings of the level's largest. Held: every logit
# within BF16_TOL x the level's largest |logit| (measured 0.011).
BF16_TOL = 0.03


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """A TINY model's flax variables with non-trivial batch norm and head
    biases (random init leaves them at identity and zero), saved by the
    JAX package's own writer."""
    _, v = jyolo.init_params(JTINY, jax.random.key(3))
    rng = np.random.default_rng(0)
    flat = {}
    for k, x in tu.flatten_dict(v).items():
        x = np.asarray(x)
        if k[-1] in ("mean", "bias"):
            x = rng.normal(0, 0.1, x.shape).astype(np.float32)
        elif k[-1] in ("var", "scale"):
            x = rng.uniform(0.5, 1.5, x.shape).astype(np.float32)
        flat[k] = x
    tree = tu.unflatten_dict(flat)
    path = str(tmp_path_factory.mktemp("w") / "tiny.npz")
    jyolo.save_weights(tree, path)
    return tree, path


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_yolo_forward_matches_jax(weights, dtype):
    """The port's Yolo loaded from the JAX package's npz against the flax
    model on the same input: in float32 (flax dtype=float32) within 1e-4
    of the level's largest value; in bfloat16 within BF16_TOL of it."""
    tree, path = weights
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    x = np.random.default_rng(1).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    jm = jyolo.Yolo(JTINY.num_classes, JTINY.width_mult, JTINY.depth_mult, dtype=jdt)
    jouts = jm.apply(jax.tree_util.tree_map(jnp.asarray, tree), jnp.asarray(x))
    tm = yolo.load_weights(path, TINY, dtype=tdt)
    with torch.no_grad():
        touts = tm(_t(x).permute(0, 3, 1, 2))
    tol = 1e-4 if dtype == "float32" else BF16_TOL
    assert len(touts) == 3
    for lvl, (jo, to) in enumerate(zip(jouts, touts)):
        for name, j, t in zip(("box", "cls"), jo, to):
            assert t.dtype == tdt
            j = np.asarray(j.astype(jnp.float32))
            t = t.float().permute(0, 2, 3, 1).numpy()
            assert j.shape == t.shape == (2, 8 >> lvl, 8 >> lvl, j.shape[-1])
            np.testing.assert_allclose(t, j, rtol=0, atol=tol * np.abs(j).max(),
                                       err_msg=f"{name} level {lvl}")


def test_decode_predictions_matches_jax():
    """The DFL decode on the same float32 head maps (NHWC for JAX, NCHW
    for the port): boxes within 1e-4 px, scores within 1e-6."""
    rng = np.random.default_rng(2)
    outs = [(rng.normal(0, 2, (2, s, s, 64)).astype(np.float32),
             rng.normal(0, 2, (2, s, s, 80)).astype(np.float32)) for s in (8, 4, 2)]
    jb, js = jyolo.decode_predictions([(jnp.asarray(b), jnp.asarray(c)) for b, c in outs], 64, 80)
    tb, ts = yolo.decode_predictions([(_t(b).permute(0, 3, 1, 2), _t(c).permute(0, 3, 1, 2))
                                      for b, c in outs], 64, 80)
    assert tb.shape == (2, 84, 4) and ts.shape == (2, 84, 80)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), atol=1e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), atol=1e-6)


@pytest.mark.parametrize("use_nms", [True, False])
def test_postprocess_matches_jax(use_nms):
    """_postprocess on the same decoded boxes and scores: with 300
    anchors, 40 of them past the gate (two pairs at equal confidence) and
    50 slots, the tail of 10 gated-out slots holds anchors of key -1 in
    jax.lax.top_k's lower-index-first order: boxes, scores, classes and
    valid flags equal, NMS or not."""
    rng = np.random.default_rng(3)
    a = 300
    xy = rng.uniform(0, 50, (a, 2))
    bxs = np.concatenate([xy, xy + rng.uniform(4, 14, (a, 2))], -1).astype(np.float32)
    scores = rng.uniform(0, 0.45, (a, 80)).astype(np.float32)
    hot = rng.choice(a, 40, replace=False)
    scores[hot, rng.integers(0, 80, 40)] = rng.uniform(0.55, 0.99, 40).astype(np.float32)
    scores[hot[1], 5] = scores[hot[0]].max()   # a tie of confidences
    scores[hot[3], :] = 0.0
    scores[hot[3], [7, 9]] = 0.8               # a tie of classes: the first wins
    cfg_kw = dict(TINY_KW, conf_threshold=0.5)
    jd = jdetect._postprocess(jnp.asarray(bxs), jnp.asarray(scores), JaxDetectorConfig(**cfg_kw),
                              48, 72, use_nms=use_nms)
    td = detect._postprocess(_t(bxs), _t(scores), DetectorConfig(**cfg_kw), 48, 72,
                             use_nms=use_nms)
    for name in ("scores", "classes", "valid"):
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)),
                                      err_msg=name)
    np.testing.assert_allclose(td.boxes.numpy(), np.asarray(jd.boxes), rtol=1e-6)
    assert td.classes.dtype == torch.int32
    assert int(td.valid.sum()) < 40 if use_nms else int(td.valid.sum()) == 40


def _nms_boxes():
    """tests/test_detector.py's 64 boxes and scores."""
    rng = np.random.default_rng(0)
    n = 64
    base = rng.uniform([0, 0], [200, 200], (n, 2))
    wh = rng.uniform(20, 60, (n, 2))
    bxs = np.concatenate([base, base + wh], -1).astype(np.float32)
    return bxs, rng.uniform(0.1, 1.0, n).astype(np.float32)


@pytest.mark.parametrize("case", ["random", "equal_scores", "batched"])
def test_nms_matches_jax(case):
    """Greedy NMS against the JAX nms on tests/test_detector.py's boxes:
    the keep masks are equal; with every score equal, argmax's first index
    decides for both; a batch of 3 equals 3 calls."""
    bxs, scores = _nms_boxes()
    valid = np.ones(len(bxs), bool)
    valid[5] = False
    if case == "equal_scores":
        scores = np.full_like(scores, 0.5)
    if case == "batched":
        rng = np.random.default_rng(4)
        bxs3 = np.stack([bxs, bxs[::-1].copy(), bxs + rng.uniform(0, 5, bxs.shape).astype(np.float32)])
        sc3 = np.stack([scores, scores, rng.uniform(0.1, 1, len(bxs)).astype(np.float32)])
        got = boxes.nms(_t(bxs3), _t(sc3), _t(np.stack([valid] * 3)), 0.45).numpy()
        for i in range(3):
            want = jboxes.nms(jnp.asarray(bxs3[i]), jnp.asarray(sc3[i]), jnp.asarray(valid), 0.45)
            np.testing.assert_array_equal(got[i], np.asarray(want))
        return
    want = np.asarray(jboxes.nms(jnp.asarray(bxs), jnp.asarray(scores), jnp.asarray(valid), 0.45))
    got = boxes.nms(_t(bxs), _t(scores), _t(valid), 0.45).numpy()
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(bxs) and not got[5]


def test_points_in_dynamic_boxes_matches_jax():
    """tests/test_detector.py's case (person yes, chair no, invalid car
    no, outside no), then random boxes and points against the JAX filter,
    one frame and a batch of frames."""
    det = Detections(boxes=_t([[10, 10, 50, 50], [100, 100, 150, 150], [60, 60, 80, 80]]).float(),
                     scores=_t([0.9, 0.9, 0.9]).float(), classes=_t([0, 56, 2]).int(),
                     valid=_t([True, True, False]))
    pts = _t([[30, 30], [120, 120], [70, 70], [200, 200]]).float()
    assert boxes.points_in_dynamic_boxes(pts, det).tolist() == [True, False, False, False]
    rng = np.random.default_rng(5)
    xy = rng.uniform(0, 300, (3, 500, 2)).astype(np.float32)
    b0 = rng.uniform(0, 250, (3, 20, 2))
    bx = np.concatenate([b0, b0 + rng.uniform(5, 80, (3, 20, 2))], -1).astype(np.float32)
    cls = rng.integers(0, 20, (3, 20)).astype(np.int32)
    valid = rng.random((3, 20)) < 0.7
    got = boxes.points_in_dynamic_boxes(_t(xy), Detections(_t(bx), _t(bx[..., 0]), _t(cls),
                                                           _t(valid)))
    for i in range(3):
        want = jboxes.points_in_dynamic_boxes(
            jnp.asarray(xy[i]), JaxDetections(jnp.asarray(bx[i]), jnp.asarray(bx[i, :, 0]),
                                              jnp.asarray(cls[i]), jnp.asarray(valid[i])))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))
    assert 0 < int(got.sum()) < got.numel()


def test_top_k_stable_matches_lax_top_k():
    """Values and indices of jax.lax.top_k, ties (many -1 keys) included."""
    rng = np.random.default_rng(6)
    x = np.where(rng.random((4, 300)) < 0.8, -1.0, rng.integers(0, 5, (4, 300)) / 4.0)
    x = x.astype(np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(x), 50)
    tv, ti = top_k_stable(_t(x), 50)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_detector_matches_jax_make_detector(weights, tmp_path):
    """make_detector against the JAX detector on the same npz and frame,
    both in bfloat16. Random weights score every anchor near 0.586, and a
    logit one bf16 rounding apart (the frameworks sum a convolution in
    other orders) lets near-equal scores swap places and NMS keep other
    representatives: the candidates' scores in order within 2e-3 and the
    same number past the 0.5 gate. The head of torch_parity_util's
    tiny_detector_npz fires regardless of rounding: there every field is
    equal (boxes within 1e-3 px of the 72x48 frame)."""
    img = np.random.default_rng(7).uniform(0, 255, (48, 72)).astype(np.float32)

    def both(path, **kw):
        cfg_kw = dict(TINY_KW, **kw)
        jd = jax.jit(jdetect.make_detector(JaxDetectorConfig(**cfg_kw), weights_path=path))(
            jnp.asarray(img))
        td = detect.make_detector(DetectorConfig(**cfg_kw), weights_path=path,
                                  device="cpu")(_t(img))
        return jd, td

    jd, td = both(weights[1], conf_threshold=0.5)
    np.testing.assert_allclose(td.scores.numpy(), np.asarray(jd.scores), atol=2e-3)
    assert int((td.scores > 0).sum()) == int((np.asarray(jd.scores) > 0).sum()) > 0
    assert 0 < int(td.valid.sum()) <= int((td.scores > 0).sum())
    jd, td = both(tiny_detector_npz(str(tmp_path / "fixed.npz")), conf_threshold=0.9,
                  max_detections=16)
    assert bool(np.asarray(jd.valid).any())
    for name in ("valid", "classes"):
        np.testing.assert_array_equal(getattr(td, name).numpy(), np.asarray(getattr(jd, name)))
    np.testing.assert_allclose(td.scores.numpy(), np.asarray(jd.scores), atol=1e-6)
    np.testing.assert_allclose(td.boxes.numpy(), np.asarray(jd.boxes), atol=1e-3)


def test_batched_detector_matches_single(weights):
    """make_batched_detector(use_nms=True) reproduces make_detector frame
    by frame; use_nms=False keeps every gated anchor."""
    model = yolo.load_weights(weights[1], TINY)
    single = detect.make_detector(TINY, model=model, device="cpu")
    batched = detect.make_batched_detector(TINY, model=model, use_nms=True, device="cpu")
    loose = detect.make_batched_detector(TINY, model=model, use_nms=False, device="cpu")
    imgs = np.random.default_rng(7).uniform(0, 255, (2, 48, 72)).astype(np.float32)
    db, dl = batched(_t(imgs)), loose(_t(imgs))
    for i in range(2):
        ds = single(_t(imgs[i]))
        np.testing.assert_allclose(db.boxes[i].numpy(), ds.boxes.numpy(), atol=1e-4)
        np.testing.assert_array_equal(db.valid[i].numpy(), ds.valid.numpy())
        np.testing.assert_array_equal(db.classes[i].numpy(), ds.classes.numpy())
        assert bool((dl.valid[i] >= db.valid[i]).all())


def test_random_detector_is_seeded_and_yolo_s_maps_from_flax():
    """init_model draws the JAX package's init for its seed (same seed,
    same weights; another seed, other kernels: tests/test_torch_train.py
    holds them against init_params); at the published width
    (DetectorConfig(): YOLO-s, 640 px) the flax tree of the JAX model
    (shapes by jax.eval_shape) loads with every key consumed, and the
    head's widths are 64 and 128."""
    a = yolo.init_model(TINY, 1)
    b = yolo.init_model(TINY, 1)
    for (na, ta), (_, tb) in zip(a.state_dict().items(), b.state_dict().items()):
        assert torch.equal(ta, tb), na
    c = yolo.init_model(TINY, 2)
    assert not torch.equal(a.state_dict()["DetectHead_0.Conv_0.kernel"],
                           c.state_dict()["DetectHead_0.Conv_0.kernel"])
    cfg = JaxDetectorConfig()
    model = jyolo.Yolo(cfg.num_classes, cfg.width_mult, cfg.depth_mult)
    shapes = jax.eval_shape(model.init, jax.random.key(0),
                            jnp.zeros((1, cfg.input_size, cfg.input_size, 3)))
    tree = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32), shapes)
    ys = convert.yolo_from_flax(tree, yolo.make_model(DetectorConfig()))
    sd = ys.state_dict()
    assert sd["DetectHead_0.Conv_0.kernel"].shape == (64, 64, 1, 1)
    assert sd["DetectHead_0.Conv_1.kernel"].shape == (80, 128, 1, 1)
    assert 10e6 < sum(v.numel() for v in sd.values()) < 12e6


def test_weight_file_contracts(weights, tmp_path):
    """load_weights reads the JAX file with every key consumed; the port's
    save_weights of a float32 model writes a file the JAX load_weights
    reads back equal (a bf16 model holds its kernels rounded); a
    missing key raises KeyError, an extra key or a wrong shape
    ValueError."""
    tree, path = weights
    model = yolo.load_weights(path, TINY, dtype=torch.float32)
    out = str(tmp_path / "port.npz")
    yolo.save_weights(model, out)
    back = tu.flatten_dict(jyolo.load_weights(out))
    ref = tu.flatten_dict(tree)
    assert set(back) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(np.asarray(back[k]), ref[k])
    flat = dict(np.load(path))
    key = "params/YoloBackboneNeck_0/C2f_1/Bottleneck_0/ConvBnAct_1/Conv_0/kernel"
    missing = {k: v for k, v in flat.items() if k != key}
    with pytest.raises(KeyError, match="C2f_1/Bottleneck_0"):
        convert.yolo_from_flax(missing, yolo.make_model(TINY))
    with pytest.raises(ValueError, match="unused"):
        convert.yolo_from_flax(dict(flat, **{"params/extra/kernel": np.zeros(3)}),
                               yolo.make_model(TINY))
    bad = dict(flat)
    bad[key] = np.zeros((3, 3, 99, 16), np.float32)
    with pytest.raises(ValueError, match="shape mismatch"):
        convert.yolo_from_flax(bad, yolo.make_model(TINY))
    assert os.path.getsize(out) > 0
