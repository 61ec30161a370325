"""The chunked evaluator's odometry path of the port (on the CPU, through
the kernels' plain versions) against the JAX package's ChunkedSlam on the
same rendered frames, IMU stream and gyro priors: the batched two-view
geometry pair by pair, the front end's pair stage key for key on the JAX
run's own features and draws, extract + pairs from the frames, the scale
chain in its three modes, and three chunks end to end."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aria_slam_tpu import config as jcfg
from aria_slam_tpu.eval.chunked import ChunkedSlam as JaxChunkedSlam
from aria_slam_tpu.ops import orb as jorb
from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch import convert
from aria_slam_tpu_torch.eval import chunked as tch
from aria_slam_tpu_torch.eval.chunked import ChunkedSlam
from aria_slam_tpu_torch.ops import epipolar as tep
from aria_slam_tpu_torch.ops import homography as thom

from test_torch_geometry import K_NP, _correspondences
from torch_parity_util import (
    JaxChunkChainSampler, JaxPairsSampler, chunk_scene, small_config, to_np,
)

CHUNK = 5
# The scene at this size has pairs whose translation direction is weakly
# observed: the gyro-fused re-solve then settles on one of two consensus
# sets (about 85 or about 20 inliers), and which one is decided by float32
# rounding. The JAX package itself lands on either, depending on the draws
# and on whether the pair is solved alone or inside its batched program
# (ROADMAP.md queue 3). With this seed both packages take the same branch
# at every pair of the three chunks.
SEED = 2
JCFG = small_config(jcfg, vo_backbone_scale=True)
TCFG = small_config(tcfg, vo_backbone_scale=True)


def _t(x):
    return torch.from_numpy(np.array(x))


# ------------------------------------------- batched geometry, pair by pair
class _FixedSampler:
    """Seeded draws, the same whether the pairs come one by one or
    stacked: pair p of a batch gets the draws of index p."""

    def __init__(self, valids, seed=0):
        self.valids = valids
        self.seed = seed
        self.one = None  # set to a pair index for an unbatched call

    def _draw(self, p, h, s, stage):
        rng = np.random.default_rng([self.seed, p, stage == "essential"])
        live = np.flatnonzero(self.valids[p])
        return torch.from_numpy(rng.choice(live, (h, s)))

    def __call__(self, valid, h, s, stage):
        if self.one is not None:
            return self._draw(self.one, h, s, stage)
        return torch.stack([self._draw(p, h, s, stage) for p in range(valid.shape[0])])


@pytest.fixture(scope="module")
def pair_batch():
    """Four pairs: two general scenes, a planar one (the homography rescue
    wins there) and one with too few matches to succeed."""
    sets = [_correspondences(0), _correspondences(1), _correspondences(2, planar=True),
            _correspondences(3, invalid=0.97)]
    xy1, xy2, valid = (np.stack([s[i] for s in sets]) for i in range(3))
    R_g = np.stack([s[3] for s in sets])
    has_g = np.array([True, False, False, True])
    return _t(xy1), _t(xy2), _t(valid), _t(R_g), _t(has_g)


def test_batched_pose_equals_pair_by_pair(pair_batch):
    """estimate_pose_gyro_fused over a leading pair axis gives what it
    gives pair by pair: masks, counts and flags exactly, R within 1e-5
    (measured 2e-6: the batched matmuls round differently) and t within
    1e-4 (measured 2.5e-5 on the pair whose translation is weakly
    observed)."""
    xy1, xy2, valid, R_g, has_g = pair_batch
    cfg = tcfg.RansacConfig(num_hypotheses=64)
    K = _t(K_NP)
    thresh_sq = (cfg.inlier_threshold_px / (0.5 * (K[0, 0] + K[1, 1]))) ** 2
    sampler = _FixedSampler(valid.numpy())
    batched = tep.estimate_pose_gyro_fused(xy1, xy2, valid, K, cfg, sampler, R_g, has_g,
                                           thresh_sq)
    assert batched.R.shape == (4, 3, 3) and batched.inlier_mask.shape == valid.shape
    for p in range(4):
        sampler.one = p
        one = tep.estimate_pose_gyro_fused(xy1[p], xy2[p], valid[p], K, cfg, sampler, R_g[p],
                                           has_g[p], thresh_sq)
        assert torch.equal(one.inlier_mask, batched.inlier_mask[p]), p
        assert int(one.num_inliers) == int(batched.num_inliers[p])
        assert bool(one.success) == bool(batched.success[p])
        np.testing.assert_allclose(one.R.numpy(), batched.R[p].numpy(), atol=1e-5)
        np.testing.assert_allclose(one.t.numpy(), batched.t[p].numpy(), atol=1e-4)
    assert batched.success.tolist() == [True, True, True, False]


def test_batched_depths_and_pins_equal_pair_by_pair(pair_batch):
    """pair_depths, pin_depths (both estimators), pin_scale, geomean_ratio,
    sampson_error of lax_skew_E and the homography RANSAC with its motion,
    batched against pair by pair: masks exactly, values within 1e-5
    (measured 4e-6)."""
    xy1, xy2, valid, _, _ = pair_batch
    cfg = tcfg.RansacConfig(num_hypotheses=64)
    K = _t(K_NP)
    sampler = _FixedSampler(valid.numpy(), seed=1)
    delta = tep.estimate_relative_pose(xy1, xy2, valid, K, cfg, sampler)
    p1, p2 = tep.normalize_points(xy1, K), tep.normalize_points(xy2, K)
    thresh_sq = (1.0 / K_NP[0, 0]) ** 2

    def batched_and_single(fn):
        full = fn(delta, xy1, xy2, valid, p1, p2, None)
        for p in range(4):
            sampler.one = p
            yield p, full, fn(delta.map(lambda x: x[p]), xy1[p], xy2[p], valid[p], p1[p], p2[p], p)
        sampler.one = None

    def depths(d, a, b, v, q1, q2, p):
        z1, z2, good = tep.pair_depths(d, a, b, v, K)
        tz, tgood = tep.pin_depths(d, a, b, v, K, "tfree_parallax", 0.55)
        pin, pin_ok = tep.pin_scale(tz, tgood, 4.0)
        ratio, cnt = tep.geomean_ratio(z1, z2, good)
        err = tep.sampson_error(tep.lax_skew_E(d.R, d.t), q1, q2)
        Hm, hmask, score = thom.estimate_homography(q1, q2, v, sampler, 32, thresh_sq)
        Rh, th, strength = thom.best_h_motion(Hm, d.R, q1, q2, hmask.float())
        return dict(good=good, tgood=tgood, pin_ok=pin_ok, hmask=hmask, score=score, cnt=cnt,
                    z1=torch.where(good, z1, 0.0), z2=torch.where(good, z2, 0.0),
                    tz=torch.where(tgood, tz, 0.0), pin=pin, ratio=ratio, err=err,
                    Hm=Hm / torch.linalg.norm(Hm, dim=(-2, -1), keepdim=True), Rh=Rh, th=th,
                    strength=strength)

    exact = ("good", "tgood", "pin_ok", "hmask", "score", "cnt")
    for p, full, one in batched_and_single(depths):
        for name, value in one.items():
            if name in exact:
                assert torch.equal(value, full[name][p]), (name, p)
            else:
                np.testing.assert_allclose(value.numpy(), full[name][p].numpy(), rtol=1e-5,
                                           atol=1e-5, err_msg=f"{name} pair {p}")


def test_torch_sampler_draws_for_every_pair():
    """TorchSampler over (B, N) masks: (B, H, S) indices, valid slots only,
    any slot for a pair with none; unbatched it keeps its (H, S) shape."""
    rng = np.random.default_rng(0)
    valid = _t(rng.random((3, 50)) > 0.6)
    valid[2] = False
    sampler = tep.TorchSampler(torch.Generator().manual_seed(0))
    idx = sampler(valid, 16, 8, "essential")
    assert idx.shape == (3, 16, 8) and idx.dtype == torch.int64
    for p in range(2):
        assert valid[p][idx[p]].all()
        assert len(torch.unique(idx[p])) > 5
    assert int(idx[2].min()) >= 0 and int(idx[2].max()) < 50
    assert sampler(valid[0], 16, 8, "homography").shape == (16, 8)


def test_scatter_last_keeps_what_jax_cpu_keeps():
    """The port's rule for several slots writing to one place (the highest
    slot wins) is what the reference's `.at[idx].set` does on the CPU:
    forced duplicates, floats and masks, exactly."""
    rng = np.random.default_rng(1)
    idx = rng.integers(0, 40, (3, 96))          # 96 writes to 40 places: many duplicates
    idx[0, :8] = 7
    vals = rng.normal(size=(3, 96)).astype(np.float32)
    mask = rng.random((3, 96)) > 0.5
    put = jax.jit(jax.vmap(lambda i, v: jnp.zeros((96,), v.dtype).at[i].set(v, mode="drop")))
    np.testing.assert_array_equal(np.asarray(put(jnp.asarray(idx), jnp.asarray(vals))),
                                  tch.scatter_last(_t(idx), _t(vals), 96).numpy())
    np.testing.assert_array_equal(np.asarray(put(jnp.asarray(idx), jnp.asarray(mask))),
                                  tch.scatter_last(_t(idx), _t(mask), 96).numpy())
    assert float(tch.scatter_last(_t(idx), _t(vals), 96)[0, 7]) == vals[0, 7]


# --------------------------------------------------- against the JAX run
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """One JAX ChunkedSlam (its compile paid once): its front end on the
    first chunk with a chosen key and one pair without a gyro prior, then
    three chunks and finalize through both packages, the port drawing the
    JAX run's own samples."""
    frames, ts, gt, imu, Rg, okg = chunk_scene(3 * CHUNK + 1)
    js = JaxChunkedSlam(JCFG, chunk=CHUNK, seed=SEED)
    res = dict(frames=frames, ts=ts, gt=gt, imu=imu, Rg=Rg, okg=okg, lag=js.lag)

    key = jax.random.key(5)
    ok_first = okg[:CHUNK].copy()
    ok_first[2] = False
    fr = jnp.asarray(frames[:CHUNK + 1])
    res["front_key"], res["front_ok"] = key, ok_first
    res["front"] = to_np(js._frontend(fr, js._zlast, js._mlast, key, jnp.asarray(Rg[:CHUNK]),
                                      jnp.asarray(ok_first)))
    feats = jax.jit(lambda f: jorb.extract_batch(f.astype(jnp.float32), JCFG.orb))(fr)
    res["feats"] = to_np(feats)

    tslam = ChunkedSlam(TCFG, chunk=CHUNK, device="cpu",
                        sampler=JaxChunkChainSampler(jax.random.key(SEED), js.lag))
    snap = str(tmp_path_factory.mktemp("snap") / "after_chunk_1.npz")
    for k in range(3):
        s = k * CHUNK
        args = (frames[s:s + CHUNK + 1], ts[s:s + CHUNK + 1], Rg[s:s + CHUNK], okg[s:s + CHUNK],
                imu)
        if k == 1:
            js.snapshot(snap)
            res["key_after_1"] = js._key
        js.process_chunk(*args)
        tslam.process_chunk(*args)
        if k == 1:
            res["jax_after_2"] = (np.stack([T for _, T in js.trajectory]), js._vis_local)
    res["snap"] = snap
    res["online"] = (np.stack([T for _, T in js.trajectory]),
                     np.stack([T for _, T in tslam.trajectory]))
    res["corr"] = ((js._imu_corr, js._vis_corr, js._ba_corr, js._vis_local),
                   (tslam._imu_corr, tslam._vis_corr, tslam._ba_corr, tslam._vis_local))
    js.finalize()
    tslam.finalize()
    res["final"] = (np.stack([T for _, T in js.trajectory]),
                    np.stack([T for _, T in tslam.trajectory]))
    res["graphs"] = (to_np(js.graph), tslam.graph)
    return res


def _front_args(run):
    nf = TCFG.orb.num_features
    return (torch.zeros(nf), torch.zeros(nf, dtype=torch.bool),
            JaxPairsSampler(run["front_key"], CHUNK, CHUNK + 1 - run["lag"]),
            _t(run["Rg"][:CHUNK]), _t(run["front_ok"]), TCFG, run["lag"])


def test_jax_features_are_the_front_ends(run):
    """The JAX extract_batch on its own gives the features the front-end
    program computed inside, so the port can be fed the run's features."""
    f, out = run["feats"], run["front"]
    np.testing.assert_array_equal(f.xy, out["fxy"])
    np.testing.assert_array_equal(f.valid, out["fvalid"])
    np.testing.assert_array_equal(f.desc[1:], out["desc"])


def test_pairs_match_frontend_key_for_key(run):
    """`pairs` on the JAX run's features and draws against the JAX front
    end: every output key present; flags, counts, masks and indices
    exactly (the duplicates rule included, through M2 and the ratios'
    counts); R, t, pins and ratios within 1e-3, depths within 5e-3
    relative (one near-degenerate depth of 1920 differs by 2.7e-3, the
    rest by under 1e-3). One pair runs without its gyro prior."""
    out = run["front"]
    got = tch.pairs(convert.features_from_numpy(run["feats"], "cpu"), *_front_args(run))
    assert set(got) == set(out)
    exact = ("ok", "ninl", "lvalid", "cinl", "midx", "okl", "pin_oks", "pinokl", "M2",
             "dvalid", "fvalid", "desc", "rcounts", "hists", "fxy", "xy", "uvl_cur", "uvl_prev")
    for name in exact:
        np.testing.assert_array_equal(out[name], got[name].numpy(), err_msg=name)
    for name in ("R", "t", "Rl", "tl", "pins", "pinl", "ratios"):
        np.testing.assert_allclose(out[name], got[name].numpy(), atol=1e-3, err_msg=name)
    np.testing.assert_allclose(out["Z2"], got["Z2"].numpy(), rtol=5e-3, atol=1e-4)
    assert (np.abs(out["Z2"] - got["Z2"].numpy()) > 1e-3 * np.abs(out["Z2"]) + 1e-4).sum() <= 2
    assert out["ok"].all() and out["okl"].all() and out["cinl"].sum() > 5 * 80
    # duplicates occurred: fewer distinct targets than strict matches
    tidx = out["midx"][0][out["cinl"][0]]
    assert len(np.unique(tidx)) <= len(tidx)


def test_extract_and_pairs_from_frames(run):
    """The port's own extract + pairs from the uint8 frames: keypoint-set
    IoU > 0.97 and descriptor Hamming mean < 4, p99 <= 24 against the JAX
    front end's features (the gates of tests/test_torch_ops.py); then
    every pair succeeds as in the JAX run, inlier counts within 10 %,
    rotations within 1e-3 (5e-3 for the pair without a gyro prior),
    translation directions within 3 degrees and pins within 10 %."""
    out = run["front"]
    feats = tch.extract(_t(run["frames"][:CHUNK + 1]), TCFG)
    ious, dists = [], []
    for b in range(1, CHUNK + 1):
        jmap = {tuple(v): i for i, v in enumerate(np.round(out["fxy"][b] * 8).astype(int))
                if out["fvalid"][b][i]}
        tmap = {tuple(v): i for i, v in enumerate(np.round(feats.xy[b].numpy() * 8).astype(int))
                if feats.valid[b][i]}
        common = set(jmap) & set(tmap)
        ious.append(len(common) / max(len(set(jmap) | set(tmap)), 1))
        dists += [int((out["desc"][b - 1][jmap[c]] != feats.desc[b].numpy()[tmap[c]]).sum())
                  for c in common]
    assert min(ious) > 0.97, ious
    assert np.mean(dists) < 4.0 and np.percentile(dists, 99) <= 24
    got = tch.pairs(feats, *_front_args(run))
    np.testing.assert_array_equal(out["ok"], got["ok"].numpy())
    np.testing.assert_array_equal(out["okl"], got["okl"].numpy())
    np.testing.assert_allclose(out["ninl"], got["ninl"].numpy(), rtol=0.1)
    gyro = run["front_ok"]
    np.testing.assert_allclose(out["R"][gyro], got["R"].numpy()[gyro], atol=1e-3)
    np.testing.assert_allclose(out["R"], got["R"].numpy(), atol=5e-3)
    cos = np.sum(out["t"] * got["t"].numpy(), -1)
    assert cos.min() > np.cos(np.radians(3.0)), cos
    np.testing.assert_allclose(out["pins"], got["pins"].numpy(), rtol=0.1)
    np.testing.assert_allclose(out["pinl"], got["pinl"].numpy(), rtol=0.1)


@pytest.mark.parametrize("mode", ["median_depth", "propagate", "unit"])
def test_chain_scales_match(run, mode):
    """_chain_scales on the JAX front end's statistics, twice in a row (the
    carried scale and trailing fallback included), with and without the
    local lag-pin correction: within 1e-6 relative."""
    out = run["front"]
    for backbone in (True, False):
        js, ts_ = JaxChunkedSlam.__new__(JaxChunkedSlam), ChunkedSlam.__new__(ChunkedSlam)
        js.cfg = dataclasses.replace(JCFG, vo_scale_mode=mode, vo_backbone_scale=backbone)
        ts_.cfg = dataclasses.replace(TCFG, vo_scale_mode=mode, vo_backbone_scale=backbone)
        for s in (js, ts_):
            s.lag = run["lag"]
            s._imu_corr, s._vis_corr, s._ba_corr = 1.3, 0.9, 1.1
            s._vis_local, s._scale = 1.0, 1.0
        for _ in range(2):
            a = js._chain_scales(out, CHUNK)
            b = ts_._chain_scales(out, CHUNK)
            np.testing.assert_allclose(a, b, rtol=1e-6)
            assert js._vis_local == pytest.approx(ts_._vis_local, rel=1e-6)
            assert js._scale == pytest.approx(ts_._scale, rel=1e-6)
        if mode == "median_depth" and backbone:
            assert ts_._vis_local != 1.0
        if mode == "unit":
            assert (b == 1.0).all()


def test_three_chunks_match_jax(run):
    """Three chunks (with chunk BA, the IMU estimator fed, gyro priors)
    and finalize through both packages with shared draws: every frame's
    position within 2 % of the path length before and after the final
    optimisation, rotations within 0.2 degrees, the correction factors
    within 2 %, and both near the rendered ground truth."""
    from aria_slam_tpu_torch.eval import metrics

    path = np.linalg.norm(np.diff(run["gt"], axis=0), axis=1).sum()
    for which in ("online", "final"):
        tj, tt = run[which]
        assert tj.shape == tt.shape == (3 * CHUNK + 1, 4, 4)
        assert np.isfinite(tt).all()
        err = np.linalg.norm(tj[:, :3, 3] - tt[:, :3, 3], axis=1)
        assert err.max() < 0.02 * path, (which, err.max(), path)
        rot = [np.degrees(np.arccos(np.clip((np.trace(a[:3, :3].T @ b[:3, :3]) - 1) / 2, -1, 1)))
               for a, b in zip(tj, tt)]
        assert max(rot) < 0.2, (which, max(rot))
    np.testing.assert_allclose(run["corr"][0], run["corr"][1], rtol=0.02)
    ate_j = metrics.ate_rmse(run["final"][0][:, :3, 3], run["gt"])
    ate_t = metrics.ate_rmse(run["final"][1][:, :3, 3], run["gt"])
    assert ate_t < 0.15 and abs(ate_t - ate_j) < 0.02, (ate_j, ate_t)
    gj, gt = run["graphs"]
    assert int(gj.num_edges) == int(gt.num_edges) == 3 * CHUNK
    np.testing.assert_array_equal(gj.edge_i, gt.edge_i.numpy())
    np.testing.assert_allclose(gj.edge_rwt, gt.edge_rwt.numpy())


def test_chunk_from_converted_jax_state(run):
    """The port started from the JAX evaluator's state after one chunk
    (convert.chunked_state_from_numpy on its snapshot file) and given the
    JAX key chain from there: the second chunk's poses within 1 % of the
    path length of the JAX run's, the carried state field for field."""
    state = np.load(run["snap"])
    tslam = ChunkedSlam(TCFG, chunk=CHUNK, device="cpu",
                        sampler=JaxChunkChainSampler(run["key_after_1"], run["lag"]))
    convert.chunked_state_from_numpy(tslam, state)
    assert tslam.frame_count == CHUNK + 1 and len(tslam.trajectory) == CHUNK + 1
    np.testing.assert_array_equal(tslam._zlast.numpy(), state["zlast"])
    np.testing.assert_array_equal(tslam.graph.node_pose.numpy(), state["graph.node_pose"])
    assert int(tslam.graph.num_edges) == CHUNK
    assert tslam._scale_est is not None and len(tslam._scale_est._ts) == CHUNK + 1
    s = CHUNK
    tslam.process_chunk(run["frames"][s:s + CHUNK + 1], run["ts"][s:s + CHUNK + 1],
                        run["Rg"][s:s + CHUNK], run["okg"][s:s + CHUNK], run["imu"])
    want, vis_local = run["jax_after_2"]
    got = np.stack([T for _, T in tslam.trajectory])
    path = np.linalg.norm(np.diff(run["gt"], axis=0), axis=1).sum()
    assert got.shape == want.shape
    assert np.linalg.norm(got[:, :3, 3] - want[:, :3, 3], axis=1).max() < 0.01 * path
    assert tslam._vis_local == pytest.approx(vis_local, rel=0.02)


# ------------------------------------------------------------ entry point
@pytest.mark.parametrize("flag", ["enable_detection"])
def test_unported_flags_raise(flag):
    """Detection was the last flag ChunkedSlam refused; it is ported now:
    with dynamic filtering beside it the evaluator builds its batched
    detector (no NMS) instead of raising, and without filtering none (the
    front end runs the detector only to filter)."""
    det = tcfg.DetectorConfig(input_size=64, width_mult=0.25, max_detections=16)
    cfg = dataclasses.replace(TCFG, detector=det, **{flag: True})
    assert ChunkedSlam(cfg, chunk=4, device="cpu")._detector is None
    slam = ChunkedSlam(dataclasses.replace(cfg, enable_dynamic_filtering=True), chunk=4,
                       device="cpu")
    assert callable(slam._detector)


def test_default_device_needs_a_card():
    """ChunkedSlam(cfg) means CUDA: without a card it raises, it does not
    carry on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ChunkedSlam(TCFG, chunk=4)
