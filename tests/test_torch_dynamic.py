"""Dynamic-object filtering in the port (on the CPU) against the JAX
package: the online step with a fixed-box detector injected into both
packages (the port fed the JAX run's features and draws, so every match
is the same), the chunked front end and three chunks with the detector
of torch_parity_util.tiny_detector_npz in both packages (one forward pass
over the chunk's frames, no NMS), and the moving-object scene of
generate(moving_object=True) against the JAX generator, then read by the
port's euroc_eval.run in both modes."""

import dataclasses
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aria_slam_tpu import config as jcfg
from aria_slam_tpu.core.types import Detections as JaxDetections
from aria_slam_tpu.eval.chunked import ChunkedSlam as JaxChunkedSlam
from aria_slam_tpu.io import euroc as jeuroc
from aria_slam_tpu.io import synthetic_scene as jsynth
from aria_slam_tpu.models import detect as jdetect
from aria_slam_tpu.ops import boxes as jboxes
from aria_slam_tpu.ops import orb as jorb
from aria_slam_tpu.pipeline.slam_pipeline import SlamPipeline as JaxPipeline
from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch import convert
from aria_slam_tpu_torch.core.types import Detections
from aria_slam_tpu_torch.eval import chunked as tch
from aria_slam_tpu_torch.eval import euroc_eval as teval
from aria_slam_tpu_torch.eval import metrics as tmetrics
from aria_slam_tpu_torch.eval.chunked import ChunkedSlam
from aria_slam_tpu_torch.io import synthetic_scene as tsynth
from aria_slam_tpu_torch.models import detect as tdetect
from aria_slam_tpu_torch.ops import boxes as tboxes
from aria_slam_tpu_torch.pipeline import factory

from torch_parity_util import (
    JAX_SMALL_CFG, JaxChainSampler, JaxChunkChainSampler, JaxPairsSampler, chunk_scene,
    small_config, tiny_detector_npz, to_np,
)

NUM_FRAMES = 12
CHUNK = 5
SEED = 2  # as tests/test_torch_chunked.py: both packages take the same RANSAC branches
# a person box over the middle, a chair (not dynamic) and an invalid car.
# With a larger person box (100..220 x 40..200) frame 4 keeps 59 matches
# and the two packages' RANSAC land on either side of the success gate on
# the same matches and draws (the float32 sensitivity of ROADMAP.md queue
# 3); at this size both take the same branch at every frame.
BOXES = np.array([[120, 70, 200, 170], [0, 0, 90, 90], [230, 120, 320, 240]], np.float32)
CLASSES = np.array([0, 56, 2], np.int32)
VALID = np.array([True, True, False])
DET_KW = dict(input_size=64, width_mult=0.25, depth_mult=0.33, max_detections=16,
              conf_threshold=0.9)


def _t(x):
    return torch.from_numpy(np.array(x))


def _rot_deg(Ra, Rb):
    return float(np.degrees(np.arccos(np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0))))


# ---------------------------------------------------------------- online
@pytest.fixture(scope="module")
def online(tmp_path_factory):
    """12 frames through both packages' SlamPipeline with filtering on and
    the same fixed-box detector; the port is fed the JAX package's ORB
    features of each frame and its RANSAC key chain."""
    out = str(tmp_path_factory.mktemp("scene"))
    jsynth.generate(out, num_frames=NUM_FRAMES, fps=5.0, cam=JAX_SMALL_CFG.camera, depth=4.0)
    data = jeuroc.load(out)
    jc = dataclasses.replace(JAX_SMALL_CFG, enable_detection=True, enable_dynamic_filtering=True)
    tc = tcfg.PipelineConfig.from_dict(jc.to_dict())
    images = [jeuroc.load_image_safe(p) for p in data.image_paths]
    extract = jax.jit(lambda im: jorb.extract(im.astype(jnp.float32), jc.orb))
    feats = [convert.features_from_numpy(to_np(extract(jnp.asarray(im))), "cpu") for im in images]
    fed = iter(feats)

    def jax_det(image):
        return JaxDetections(jnp.asarray(BOXES), jnp.ones(3), jnp.asarray(CLASSES),
                             jnp.asarray(VALID))

    def torch_det(image):
        return Detections(_t(BOXES), torch.ones(3), _t(CLASSES), _t(VALID))

    jpipe = JaxPipeline(jc, seed=0, detector=jax_det)
    tpipe = factory.create_cpu(tc, sampler=JaxChainSampler(jax.random.key(0)),
                               detector=torch_det, extractor=lambda image: next(fed))
    res = {"jax": [], "torch": [], "cfg": tc}
    for k, im in enumerate(images):
        if k == NUM_FRAMES - 1:
            res["carry"], res["t0"] = to_np(jpipe.state), jpipe._t0
        for pipe, name in ((jpipe, "jax"), (tpipe, "torch")):
            pipe.process_frame(im, data.image_ts[k])
            o = pipe.last_output
            res[name].append((int(o.num_matches), int(o.num_filtered), bool(o.vo_success)))
    res["dets"] = tpipe.last_output.detections
    res["poses"] = ([T for _, T in jpipe.trajectory], [T for _, T in tpipe.trajectory])
    res["images"], res["ts"], res["feats"] = images, data.image_ts, feats
    return res


def test_online_filter_matches_jax(online):
    """Every frame: the same matches kept, the same number filtered (the
    person box drops some, the chair and the invalid car none) and the
    same VO verdict (one frame of the 11 pairs fails in both); poses
    within the online slice's tolerances (tests/test_torch_pipeline.py:
    rotations within 0.5 degrees, positions within 2 % of the path); the
    step's detections are the detector's."""
    assert online["jax"] == online["torch"]
    assert all(f > 0 for _, f, _ in online["torch"][1:])
    assert sum(ok for *_, ok in online["torch"]) >= NUM_FRAMES - 3
    jT, tT = (np.stack(p) for p in online["poses"])
    path = np.linalg.norm(np.diff(jT[:, :3, 3], axis=0), axis=1).sum()
    assert np.linalg.norm(jT[:, :3, 3] - tT[:, :3, 3], axis=1).max() <= 0.02 * path
    assert max(_rot_deg(a[:3, :3], b[:3, :3]) for a, b in zip(jT, tT)) <= 0.5
    assert torch.equal(online["dets"].boxes, _t(BOXES))


def test_one_step_from_jax_carry_filters_the_same(online):
    """The port's step started from the JAX carry before the last frame
    (convert.py) filters as many matches as the JAX step did."""
    k = NUM_FRAMES - 1
    pipe = factory.create_cpu(
        online["cfg"], sampler=JaxChainSampler(jax.random.wrap_key_data(online["carry"].key)),
        detector=lambda image: Detections(_t(BOXES), torch.ones(3), _t(CLASSES), _t(VALID)),
        extractor=lambda image: online["feats"][k])
    pipe.state = convert.frame_state_from_numpy(online["carry"], "cpu")
    pipe._t0 = online["t0"]
    pipe.process_frame(online["images"][k], online["ts"][k])
    o = pipe.last_output
    assert (int(o.num_matches), int(o.num_filtered)) == online["jax"][k][:2]


# --------------------------------------------------------------- chunked
@pytest.fixture(scope="module")
def chunked(tmp_path_factory):
    """The JAX ChunkedSlam with detection and filtering on and the TINY
    npz at conf 0.9: its front end on the first chunk with a chosen key,
    its detector's per-frame masks on its own features, then three chunks
    and finalize through both packages (the port drawing the JAX run's
    samples)."""
    npz = tiny_detector_npz(str(tmp_path_factory.mktemp("w") / "tiny.npz"))
    kw = dict(vo_backbone_scale=True, enable_detection=True, enable_dynamic_filtering=True)
    jc = small_config(jcfg, detector=jcfg.DetectorConfig(**DET_KW), detector_weights=npz, **kw)
    tc = small_config(tcfg, detector=tcfg.DetectorConfig(**DET_KW), detector_weights=npz, **kw)
    frames, ts, gt, imu, Rg, okg = chunk_scene(3 * CHUNK + 1)
    js = JaxChunkedSlam(jc, chunk=CHUNK, seed=SEED)
    key = jax.random.key(5)
    fr = jnp.asarray(frames[:CHUNK + 1])
    res = {"front": to_np(js._frontend(fr, js._zlast, js._mlast, key, jnp.asarray(Rg[:CHUNK]),
                                       jnp.asarray(okg[:CHUNK]))),
           "key": key, "lag": js.lag, "tc": tc, "frames": frames, "Rg": Rg, "okg": okg}
    feats = jax.jit(lambda f: jorb.extract_batch(f.astype(jnp.float32), jc.orb))(fr)
    res["feats"] = to_np(feats)
    jdets = jax.jit(jdetect.make_batched_detector(jc.detector, weights_path=npz,
                                                  use_nms=False))(fr)
    res["jax_dyn"] = np.asarray(jax.vmap(jboxes.points_in_dynamic_boxes)(feats.xy, jdets))
    tslam = ChunkedSlam(tc, chunk=CHUNK, device="cpu",
                        sampler=JaxChunkChainSampler(jax.random.key(SEED), js.lag))
    for k in range(3):
        s = k * CHUNK
        args = (frames[s:s + CHUNK + 1], ts[s:s + CHUNK + 1], Rg[s:s + CHUNK], okg[s:s + CHUNK],
                imu)
        js.process_chunk(*args)
        tslam.process_chunk(*args)
    js.finalize()
    tslam.finalize()
    res["final"] = (np.stack([T for _, T in js.trajectory]),
                    np.stack([T for _, T in tslam.trajectory]))
    res["gt"], res["tslam"] = gt, tslam
    return res


def test_chunk_masks_and_front_end_match_jax(chunked):
    """The port's batched detector (bf16, no NMS) on the chunk's C+1
    frames gives the JAX one's per-frame dynamic masks on the JAX
    features; `pairs` with those masks, the JAX features and draws gives
    the JAX front end's filtered outputs: dvalid (the DB's features) and
    the histograms, the consecutive and lag validity, the chunk BA track
    links, exactly; the masks drop features in every frame."""
    f = chunked["feats"]
    tfeats = convert.features_from_numpy(f, "cpu")
    det = tdetect.make_batched_detector(chunked["tc"].detector,
                                        weights_path=chunked["tc"].detector_weights,
                                        use_nms=False, device="cpu")
    dyn = tboxes.points_in_dynamic_boxes(tfeats.xy, det(_t(chunked["frames"][:CHUNK + 1])))
    np.testing.assert_array_equal(dyn.numpy(), chunked["jax_dyn"])
    assert (dyn & tfeats.valid).sum(1).min() > 0
    nf = chunked["tc"].orb.num_features
    got = tch.pairs(tfeats, torch.zeros(nf), torch.zeros(nf, dtype=torch.bool),
                    JaxPairsSampler(chunked["key"], CHUNK, CHUNK + 1 - chunked["lag"]),
                    _t(chunked["Rg"][:CHUNK]), _t(chunked["okg"][:CHUNK]), chunked["tc"],
                    chunked["lag"], dyn)
    out = chunked["front"]
    for name in ("dvalid", "hists", "ok", "lvalid", "cinl", "midx", "okl", "M2"):
        np.testing.assert_array_equal(out[name], got[name].numpy(), err_msg=name)
    np.testing.assert_array_equal(out["dvalid"].sum(1), (f.valid[1:] & ~dyn[1:].numpy()).sum(1))
    np.testing.assert_allclose(out["R"], got["R"].numpy(), atol=1e-3)


def test_chunked_with_detection_matches_jax(chunked):
    """Three chunks and finalize with the detector in the front end: Sim3
    ATE within 0.05 m of the JAX run's and under the JAX test's 0.6 m gate
    (tests/test_chunked.py test_chunked_with_detection_enabled)."""
    tj, tt = chunked["final"]
    assert tt.shape == tj.shape and np.isfinite(tt).all()
    ate_j = tmetrics.ate_rmse(tj[:, :3, 3], chunked["gt"])
    ate_t = tmetrics.ate_rmse(tt[:, :3, 3], chunked["gt"])
    assert ate_t < 0.6 and abs(ate_t - ate_j) <= 0.05, (ate_j, ate_t)


# ------------------------------------------------------- the moving object
@pytest.fixture(scope="module")
def moving_scene(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("moving"))
    kw = dict(num_frames=10, fps=5.0, depth=4.0, moving_object=True, object_size=1.4)
    jsynth.generate(out + "/jax", cam=JAX_SMALL_CFG.camera, **kw)
    tsynth.generate(out + "/port", cam=tcfg.PipelineConfig.from_dict(
        JAX_SMALL_CFG.to_dict()).camera, **kw)
    return out


def test_generate_moving_object_matches_jax(moving_scene):
    """generate(moving_object=True): boxes.csv identical to the JAX
    generator's (a row a frame with the panel in view) and every frame
    within the renderer tolerance of tests/test_torch_eval.py."""
    a = open(os.path.join(moving_scene, "port/mav0/cam0/boxes.csv")).read()
    b = open(os.path.join(moving_scene, "jax/mav0/cam0/boxes.csv")).read()
    assert a == b and len(a.splitlines()) == 11
    d = "mav0/cam0/data"
    names = sorted(os.listdir(os.path.join(moving_scene, "port", d)))
    assert names == sorted(os.listdir(os.path.join(moving_scene, "jax", d)))
    for name in names:
        ours = cv2.imread(os.path.join(moving_scene, "port", d, name), cv2.IMREAD_GRAYSCALE)
        ref = cv2.imread(os.path.join(moving_scene, "jax", d, name), cv2.IMREAD_GRAYSCALE)
        diff = np.abs(ours.astype(int) - ref.astype(int))
        assert (diff <= 1).mean() >= 0.99 and diff.mean() < 0.3, (name, diff.mean())


def test_euroc_eval_filters_the_moving_object(moving_scene, tmp_path, monkeypatch):
    """The port's euroc_eval.run on its moving-object scene with filtering
    on: online with a detector that returns the frame's ground-truth panel
    box (boxes.csv) as a person, through the factory's detector=
    argument: every frame after the first filters matches; chunked (chunk
    4) with the TINY npz in the front end; both finite."""
    from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline

    scene = os.path.join(moving_scene, "port")
    rows = [np.array(line.split(",")[1:], np.float32) for line in
            open(os.path.join(scene, "mav0/cam0/boxes.csv")).read().splitlines()[1:]]
    seen, outs = [], []

    def gt_detector(image):
        box = rows[len(seen)]  # a row a frame (test_generate_moving_object_matches_jax)
        seen.append(box)
        return Detections(_t(box[None]), torch.ones(1), torch.zeros(1, dtype=torch.int32),
                          torch.ones(1, dtype=torch.bool))

    process_frame = SlamPipeline.process_frame

    def recorded(self, *a):
        pose = process_frame(self, *a)
        o = self.last_output
        outs.append((int(o.num_filtered), bool(o.vo_success)))
        return pose

    monkeypatch.setattr(SlamPipeline, "process_frame", recorded)
    cfg = small_config(tcfg, enable_detection=True, enable_dynamic_filtering=True)
    res = teval.run(scene, out_dir=str(tmp_path / "online"), config=cfg, verbose=False, chunk=0,
                    device="cpu", detector=gt_detector)
    assert len(seen) == len(outs) == res["frames"] == 10 and np.isfinite(res["ate_rmse_m"])
    assert all(f > 0 for f, _ in outs[1:]), outs
    npz = tiny_detector_npz(str(tmp_path / "tiny.npz"))
    ccfg = dataclasses.replace(cfg, detector=tcfg.DetectorConfig(**DET_KW), detector_weights=npz)
    res = teval.run(scene, out_dir=str(tmp_path / "chunked"), config=ccfg, verbose=False,
                    chunk=4, device="cpu")
    assert res["frames"] == 10 and np.isfinite(res["ate_rmse_m"])
