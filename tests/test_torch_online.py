"""The online slice with every feature on, on the CPU, against the JAX
package: the online EKF (frame_step, predict, update, pose_covariance),
the keyframe ring's single insert, the loop candidates' exact scores and
`detect`, the two epipolar helpers, the whole SlamPipeline with fusion,
loop closure and mapping (the JAX pipeline's own RANSAC key chain
injected through the sampler), one step from a JAX carry through
convert.py, and the pipelined (lazy) mode against the synchronous one."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aria_slam_tpu import config as jcfg_mod
from aria_slam_tpu.backend import keyframe_db as jkdb
from aria_slam_tpu.backend import loop_closure as jlc
from aria_slam_tpu.core.types import EkfState as JEkfState
from aria_slam_tpu.core.types import Features as JFeatures
from aria_slam_tpu.core.types import Matches as JMatches
from aria_slam_tpu.core.types import PoseDelta as JPoseDelta
from aria_slam_tpu.eval import metrics as jmetrics
from aria_slam_tpu.fusion import ekf as jekf
from aria_slam_tpu.io import euroc, synthetic_scene
from aria_slam_tpu.ops import epipolar as jep
from aria_slam_tpu.pipeline.slam_pipeline import SlamPipeline as JaxPipeline
from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch import convert
from aria_slam_tpu_torch.backend import keyframe_db as tkdb
from aria_slam_tpu_torch.backend import loop_closure as tlc
from aria_slam_tpu_torch.backend import pose_graph as tpg
from aria_slam_tpu_torch.core.types import PoseDelta as TPoseDelta
from aria_slam_tpu_torch.core.types import Matches
from aria_slam_tpu_torch.eval import metrics as tmetrics
from aria_slam_tpu_torch.fusion import ekf as tekf
from aria_slam_tpu_torch.io import synthetic_scene as tsynth
from aria_slam_tpu_torch.ops import epipolar as tep
from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline

from torch_parity_util import (
    ONLINE_SCENE, ONLINE_SEED, JaxChainSampler, JaxPairsSampler, online_config, to_np,
)

DETECT_FRAME = 20  # a loop frame (against frame 0): detect on the JAX step's inputs
CARRY_FRAME = 21   # the JAX carry before this loop frame (against 1) seeds one port step
EKF_CFG_J, EKF_CFG_T = jcfg_mod.EkfConfig(), tcfg.EkfConfig()


def _t(x):
    return torch.from_numpy(np.array(x))


def _feed(pipe, data, k, t_prev):
    """One frame as euroc_eval feeds it: IMU samples in (t_prev, ts]."""
    ts = data.image_ts[k]
    imu_t, imu_a, imu_g = euroc.imu_window(data, t_prev, ts)
    for j in range(len(imu_t)):
        pipe.process_imu(imu_t[j], imu_a[j], imu_g[j])
    pipe.process_frame(euroc.load_image_safe(data.image_paths[k]), ts)
    o = pipe.last_output
    return (int(o.num_features), int(o.num_matches), int(o.num_inliers),
            bool(o.vo_success), bool(o.loop.detected))


def _buffers(pipe):
    """The storage of the keyframe DB's and the map's fields."""
    return [t.data_ptr() for t in (*vars(pipe.state.db).values(),
                                   *vars(pipe.state.map_state).values())
            if t.dim() > 0]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both pipelines over the scene, frame by frame; the JAX run also
    records what its EKF consumed a frame (the packed IMU window, the VO
    pose and flag) and its carry before CARRY_FRAME."""
    out = str(tmp_path_factory.mktemp("scene"))
    jcfg = online_config(jcfg_mod)
    synthetic_scene.generate(out, cam=jcfg.camera, **ONLINE_SCENE)
    data = euroc.load(out)
    jcfg = dataclasses.replace(jcfg, camera=data.camera,
                               imu_cam_rotation=tuple(map(tuple, data.R_cam_imu.tolist())))
    tcfg_ = tcfg.PipelineConfig.from_dict(jcfg.to_dict())
    jpipe = JaxPipeline(jcfg, seed=ONLINE_SEED)
    tpipe = SlamPipeline(tcfg_, device="cpu",
                         sampler=JaxChainSampler(jax.random.key(ONLINE_SEED)))
    windows = []
    drain = jpipe._drain_imu

    def recording_drain(ts):
        w = drain(ts)
        windows.append(w)
        return w

    jpipe._drain_imu = recording_drain
    res = {"data": data, "jcfg": jcfg, "cfg": tcfg_, "jax": [], "torch": [], "ekf_in": [],
           "loops": ([], []), "buffers": _buffers(tpipe)}
    jpipe.on_loop = lambda i, j, s: res["loops"][0].append((i, j))
    tpipe.on_loop = lambda i, j, s: res["loops"][1].append((i, j))
    fused_j, fused_t, t_prev = [], [], -np.inf
    for k in range(ONLINE_SCENE["num_frames"]):
        if k == DETECT_FRAME:
            res["db_before"] = to_np(jpipe.state.db)  # the JAX step donates its carry
            res["k_loop"] = jax.random.split(jpipe.state.key, 3)[2]
        if k == CARRY_FRAME:
            res["carry"] = to_np(jpipe.state)
            res["key"] = jax.random.key_data(jpipe.state.key)
            res["t0"], res["t_prev"] = jpipe._t0, t_prev
        res["jax"].append(_feed(jpipe, data, k, t_prev))
        o = jpipe.last_output
        res["ekf_in"].append((windows[-1], np.asarray(o.pose), bool(o.vo_success),
                              float(jpipe._rel(data.image_ts[k]))))
        fused_j.append(np.asarray(o.fused_pos))
        if k == DETECT_FRAME:
            # what its loop query consumed: the frame's features, unit
            # depths and metric scale
            res["query"] = to_np((jpipe.state.prev_feats, jpipe.state.prev_depths,
                                  jpipe.state.prev_depth_mask, jpipe.state.vo_scale))
            res["query_loop"] = to_np(o.loop)
        if k == CARRY_FRAME:
            res["jax_out"], res["jax_pose"] = to_np(o), np.asarray(jpipe.state.pose)
            res["jax_map_count"] = int(jpipe.state.map_state.count)
        if k == 5:
            res["no_loop"] = to_np(o.loop)
        res["torch"].append(_feed(tpipe, data, k, t_prev))
        fused_t.append(tpipe.last_output.fused_pos.numpy())
        t_prev = data.image_ts[k]
    res["fused"] = (np.stack(fused_j), np.stack(fused_t))
    res["map"] = (int(jpipe.state.map_state.count), int(tpipe.state.map_state.count))
    jpipe.finalize()
    tpipe.finalize()
    res["final"] = (np.stack([T for _, T in jpipe.trajectory]),
                    np.stack([T for _, T in tpipe.trajectory]))
    res["gt"] = np.stack([synthetic_scene.trajectory(ts - data.image_ts[0],
                                                     period=ONLINE_SCENE["period"])[0]
                          for ts in data.image_ts])
    res["tpipe"] = tpipe
    return res


# ------------------------------------------------------------------- EKF
def _ekf_close(js, ts, atol=1e-5):
    for name in JEkfState.__dataclass_fields__:
        np.testing.assert_allclose(np.asarray(getattr(ts, name)),
                                   np.asarray(getattr(js, name)), rtol=0, atol=atol,
                                   err_msg=name)


def _random_ekf_state(rng, initialized=True):
    q = rng.normal(size=4)
    A = rng.normal(size=(15, 15)) * 0.05
    return dict(pos=rng.normal(size=3), vel=rng.normal(size=3) * 0.3, quat=q / np.linalg.norm(q),
                ba=rng.normal(size=3) * 0.01, bg=rng.normal(size=3) * 0.001,
                P=A @ A.T + np.eye(15) * 1e-3, last_imu_t=np.float32(1.0),
                initialized=np.bool_(initialized))


def _states(d):
    d = {k: np.asarray(v, np.float32) if k != "initialized" else np.asarray(v)
         for k, v in d.items()}
    return (JEkfState(**{k: jnp.asarray(v) for k, v in d.items()}),
            tekf.EkfState(**{k: _t(v) for k, v in d.items()}))


def test_ekf_predict_update_and_covariance_match_jax():
    """predict (a step, a gated step of dt > max_dt), update (the
    initialisation, an update, a gated measurement) and pose_covariance
    against the JAX functions on the same random states, within 1e-5."""
    rng = np.random.default_rng(0)
    js, ts = _states(_random_ekf_state(rng))
    acc, gyr = rng.normal(size=3).astype(np.float32), rng.normal(size=3).astype(np.float32)
    predict = jax.jit(jekf.predict, static_argnums=4)
    update = jax.jit(jekf.update, static_argnums=4)
    for t in (1.005, 1.5):  # the second is gated (dt 0.5 s > 0.1 s)
        _ekf_close(predict(js, jnp.float32(t), jnp.asarray(acc), jnp.asarray(gyr), EKF_CFG_J),
                   tekf.predict(ts, torch.tensor(t), _t(acc), _t(gyr), EKF_CFG_T))
    R = synthetic_scene.trajectory(0.7)[1].astype(np.float32)
    p = rng.normal(size=3).astype(np.float32)
    for init, valid in ((False, True), (True, True), (True, False)):
        js, ts = _states(_random_ekf_state(rng, initialized=init))
        _ekf_close(update(js, jnp.asarray(R), jnp.asarray(p), jnp.float32(2.0), EKF_CFG_J,
                          jnp.asarray(valid)),
                   tekf.update(ts, _t(R), _t(p), torch.tensor(2.0), EKF_CFG_T,
                               torch.tensor(valid)))
    np.testing.assert_array_equal(tekf.pose_covariance(ts).numpy(),
                                  np.asarray(jekf.pose_covariance(js)))


def test_ekf_frame_step_matches_jax_on_the_pipelines_inputs(runs):
    """frame_step over the whole scene, fed what the JAX pipeline's EKF
    consumed each frame (its packed IMU windows with the padded invalid
    samples behind, its VO poses and flags): the port's state within 1e-5
    of JAX frame_step's after every frame, and the JAX replay equal to
    the JAX pipeline's own fused track."""
    js, ts = jekf.init_state(), tekf.init_state(device="cpu")
    jstep = jax.jit(jekf.frame_step, static_argnums=9)
    for k, ((it, ia, ig, iv), pose, ok, ft) in enumerate(runs["ekf_in"]):
        assert iv.sum() < len(iv)  # padded invalid samples in every window
        js = jstep(js, *(jnp.asarray(x) for x in (it, ia, ig, iv)),
                             jnp.asarray(pose[:3, :3]), jnp.asarray(pose[:3, 3]),
                             jnp.asarray(ok) | ~js.initialized, jnp.float32(ft), EKF_CFG_J)
        ts = tekf.frame_step(ts, _t(it), _t(ia), _t(ig), iv, _t(pose[:3, :3]),
                             _t(pose[:3, 3]), torch.tensor(ok) | ~ts.initialized,
                             torch.tensor(ft, dtype=torch.float32), EKF_CFG_T)
        _ekf_close(js, ts)
        np.testing.assert_allclose(np.asarray(js.pos), runs["fused"][0][k], rtol=0, atol=1e-5)


# ------------------------------------------------- keyframe DB, loop closure
def test_add_keyframe_over_a_ring_wrap_and_covisible_slots():
    """Six single inserts into a 4-slot ring: every field exactly as the
    JAX DB's after each (the wrap evicts and relinks), and covisible_slots
    of every slot."""
    rng = np.random.default_rng(1)
    lcj = jcfg_mod.LoopClosureConfig(max_keyframes=4)
    orbj = jcfg_mod.OrbConfig(num_features=16)
    jdb = jkdb.init_db(lcj, orbj)
    tdb = tkdb.init_db(tcfg.LoopClosureConfig(max_keyframes=4),
                       tcfg.OrbConfig(num_features=16), "cpu")
    for fid in range(6):
        f = dict(xy=rng.uniform(0, 300, (16, 2)).astype(np.float32),
                 desc=rng.integers(0, 2, (16, 256)).astype(np.int8),
                 valid=rng.random(16) > 0.2)
        pose = np.eye(4, dtype=np.float32)
        pose[:3, 3] = rng.normal(size=3)
        jf = JFeatures(xy=jnp.asarray(f["xy"]), response=jnp.zeros(16), angle=jnp.zeros(16),
                          octave=jnp.zeros(16, jnp.int32), size=jnp.zeros(16),
                          desc=jnp.asarray(f["desc"]), valid=jnp.asarray(f["valid"]))
        jdb = jkdb.add_keyframe(jdb, jf, 10 * fid, jnp.asarray(pose))
        tdb = tkdb.add_keyframe(tdb, convert.features_from_numpy(to_np(jf), "cpu"), 10 * fid,
                                _t(pose))
        for name in tdb.__dataclass_fields__:
            np.testing.assert_array_equal(getattr(tdb, name).numpy(),
                                          np.asarray(getattr(jdb, name)), err_msg=name)
    for slot in range(4):
        np.testing.assert_array_equal(tkdb.covisible_slots(tdb, slot).numpy(),
                                      np.asarray(jkdb.covisible_slots(jdb, slot)))


def test_full_scores_match_jax_exactly(runs):
    """The exact candidate scores (integer match counts over the valid
    queries) of one query (C = 1, the online score) and of three at once
    (C = 3, the chunked evaluator's layout) against the JAX _full_scores,
    on the DB of the scene's first 20 frames."""
    tdb = convert.keyframe_db_from_numpy(runs["db_before"], "cpu")
    jdb = jax.tree_util.tree_map(jnp.asarray, runs["db_before"])
    rng = np.random.default_rng(2)
    ratio = runs["cfg"].loop.ratio
    queries = [0, 7, 13]
    slots = np.stack([rng.choice(20, 8, replace=False) for _ in queries]).astype(np.int32)
    want = np.stack([np.asarray(jlc._full_scores(
        jdb, JFeatures(xy=jdb.xy[q], response=None, angle=None, octave=None, size=None,
                          desc=jdb.desc[q], valid=jdb.desc_valid[q]),
        jnp.asarray(s), ratio)) for q, s in zip(queries, slots)])
    got = tlc._full_scores(tdb, tdb.desc[queries], tdb.desc_valid[queries],
                           _t(slots).long(), ratio)
    np.testing.assert_array_equal(got.numpy(), want)
    one = tlc._full_scores(tdb, tdb.desc[queries[:1]], tdb.desc_valid[queries[:1]],
                           _t(slots[:1]).long(), ratio)
    np.testing.assert_array_equal(one.numpy(), want[:1])
    assert (want > 0.05).any()


@pytest.mark.parametrize("case", ["revisit", "no_candidate"])
def test_detect_matches_jax(runs, case):
    """detect on the DB before the loop frame's insert (the scene's frames
    0-19) with the loop frame's features, unit depths and scale as the
    JAX step had them, and its verification's JAX draws. A revisit (frame
    20 against frame 0): detected, slot, frame id, score and inliers as
    the JAX pipeline's frame 20, T_rel and t_weight within 1e-3. No
    candidate (frame id 5: the gap gate leaves none, so the verify is
    skipped): the empty LoopResult of the JAX pipeline's frame 5."""
    cfg = runs["cfg"]
    feats, depths, dmask, scale = runs["query"]
    fid = DETECT_FRAME if case == "revisit" else 5
    got = tlc.detect(convert.keyframe_db_from_numpy(runs["db_before"], "cpu"),
                     convert.features_from_numpy(feats, "cpu"), fid, _t(cfg.camera.K),
                     cfg.loop, cfg.ransac,
                     JaxPairsSampler(runs["k_loop"], cfg.loop.top_k_candidates, 0),
                     cfg.vo_scale_mode, cfg.vo_scene_depth, _t(depths), _t(dmask), _t(scale))
    want = runs["query_loop"] if case == "revisit" else runs["no_loop"]
    for name in ("detected", "slot", "frame_id", "score", "num_inliers"):
        assert getattr(got, name).item() == getattr(want, name).item(), name
    np.testing.assert_allclose(got.T_rel.numpy(), want.T_rel, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got.t_weight.item(), want.t_weight, atol=1e-3)
    assert bool(want.detected) == (case == "revisit")
    if case == "revisit":
        assert int(want.frame_id) == 0


# ------------------------------------------------------------- epipolar
def test_scale_translation_and_gather_correspondences():
    rng = np.random.default_rng(3)
    K = np.array([[200.0, 0, 160.0], [0, 200.0, 120.0], [0, 0, 1.0]], np.float32)
    X = rng.uniform([-2, -1.5, 3], [2, 1.5, 6], (60, 3))
    R = synthetic_scene.trajectory(0.4)[1]
    t = np.array([0.3, -0.05, 0.1])
    X2 = X @ R.T + t
    xy1 = (X[:, :2] / X[:, 2:] * 200.0 + [160.0, 120.0]).astype(np.float32)
    xy2 = (X2[:, :2] / X2[:, 2:] * 200.0 + [160.0, 120.0]).astype(np.float32)
    valid = rng.random(60) > 0.1
    inl = valid & (rng.random(60) > 0.1)
    tu = (t / np.linalg.norm(t)).astype(np.float32)
    args = (xy1, xy2, valid, K)
    want = jep.scale_translation(
        JPoseDelta(R=jnp.asarray(R, jnp.float32), t=jnp.asarray(tu), num_inliers=jnp.int32(0),
                   inlier_mask=jnp.asarray(inl), success=jnp.asarray(True)),
        *(jnp.asarray(a) for a in args), 4.0)
    got = tep.scale_translation(
        TPoseDelta(R=_t(R.astype(np.float32)), t=_t(tu), num_inliers=torch.tensor(0),
                   inlier_mask=_t(inl), success=torch.tensor(True)), *(_t(a) for a in args), 4.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    q, tr = rng.integers(0, 60, 40).astype(np.int32), rng.integers(0, 60, 40).astype(np.int32)
    jm = JMatches(query_idx=jnp.asarray(q), train_idx=jnp.asarray(tr),
                              distance=jnp.zeros(40), valid=jnp.asarray(valid[:40]))
    tm = Matches(query_idx=_t(q), train_idx=_t(tr), distance=torch.zeros(40), valid=_t(valid[:40]))
    for a, b in zip(tep.gather_correspondences(_t(xy1), _t(xy2), tm),
                    jep.gather_correspondences(jnp.asarray(xy1), jnp.asarray(xy2), jm)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# -------------------------------------------------------- the whole slice
def test_slice_matches_jax_pipeline(runs):
    """Fusion, loop closure and mapping on, the same frames, IMU and RANSAC
    draws: per-frame features, matches, VO success and loop flags equal,
    inliers within 2 (as tests/test_torch_pipeline.py: a point on the
    Sampson gate follows the float32 summation order); the loop events
    (frame pairs) equal; the map's count within 10 %; the final Sim3 ATE
    and the online fused track's Sim3 ATE each within 0.05 m of the JAX
    run's."""
    for (fj, mj, ij, okj, lj), (ft, mt, it, okt, lt) in zip(runs["jax"], runs["torch"]):
        assert (ft, mt, okt, lt) == (fj, mj, okj, lj)
        assert abs(it - ij) <= 2, (ij, it)
    jl, tl = runs["loops"]
    assert tl == jl and len(tl) >= 2, (jl, tl)
    mj, mt = runs["map"]
    assert abs(mt - mj) <= 0.1 * mj and mt > 50, (mj, mt)
    (jT, tT), gt = runs["final"], runs["gt"]
    ate_j, ate_t = jmetrics.ate_rmse(jT[:, :3, 3], gt), tmetrics.ate_rmse(tT[:, :3, 3], gt)
    fj, ft = (m.ate_rmse(f, gt) for m, f in zip((jmetrics, tmetrics), runs["fused"]))
    print(f"Sim3 ATE port {ate_t:.4f} m, JAX {ate_j:.4f} m; fused port {ft:.4f} m, "
          f"JAX {fj:.4f} m; map {mt} / {mj}; loops {tl}")
    assert np.isfinite(tT).all() and abs(ate_t - ate_j) <= 0.05, (ate_j, ate_t)
    assert np.isfinite(runs["fused"][1]).all() and abs(ft - fj) <= 0.05, (fj, ft)


def test_db_and_map_are_written_in_place(runs):
    """24 steps and their inserts left the keyframe DB (its descriptors,
    coordinates, masks, histograms, ids, poses, covisibility) and the map
    in the buffers the pipeline allocated: nothing was cloned a frame."""
    assert _buffers(runs["tpipe"]) == runs["buffers"]


def test_map_export_and_fused_pose(runs, tmp_path):
    """export_map writes the outlier-filtered map; fused_pose and its 6 x 6
    covariance come from the EKF state."""
    pipe = runs["tpipe"]
    n = pipe.export_map(str(tmp_path / "m.ply"), str(tmp_path / "m.pcd"))
    assert 0 < n == int(pipe.get_map().valid.sum()) <= int(pipe.state.map_state.count)
    assert f"element vertex {n}" in (tmp_path / "m.ply").read_text()
    T = pipe.fused_pose
    np.testing.assert_array_equal(T[:3, 3], pipe.state.ekf_state.pos.numpy())
    cov = pipe.fused_pose_covariance
    assert cov.shape == (6, 6) and np.allclose(cov, cov.T) and (np.diag(cov) > 0).all()


def test_one_step_from_jax_carry(runs):
    """The port's step started from the JAX carry before the loop frame
    (EKF state, keyframe DB and map included, through convert.py) gives
    the JAX pipeline's frame: counts and the loop exact, the map's count
    within 1 %, the step's pose and fused position within 2e-3 / 1e-3 m;
    the loop's T_rel and the pose rebased on it within 1e-2 (the
    verification's Sampson polish moves this pair's T_rel by 5e-3 in
    float32 between the packages, a rounding sensitivity of the
    reference; test_detect_matches_jax holds frame 20's at 1e-3)."""
    data, k = runs["data"], CARRY_FRAME
    pipe = SlamPipeline(runs["cfg"], device="cpu",
                        sampler=JaxChainSampler(jax.random.wrap_key_data(runs["key"])))
    pipe.state = convert.frame_state_from_numpy(runs["carry"], "cpu")
    pipe._t0 = runs["t0"]
    assert pipe.state.frame_id == k and int(pipe.state.db.size) == k
    loops = []
    pipe.on_loop = lambda i, j, s: loops.append((i, j))
    f, m, inl, ok, lp = _feed(pipe, data, k, runs["t_prev"])
    fj, mj, inlj, okj, lpj = runs["jax"][k]
    assert (f, m, ok, lp) == (fj, mj, okj, lpj) and abs(inl - inlj) <= 2
    assert loops == [(1, k)]
    jo = runs["jax_out"]
    o = pipe.last_output
    for name in ("slot", "frame_id", "num_inliers"):
        assert getattr(o.loop, name).item() == getattr(jo.loop, name).item(), name
    np.testing.assert_allclose(o.loop.T_rel.numpy(), jo.loop.T_rel, atol=1e-2)
    np.testing.assert_allclose(o.pose.numpy(), jo.pose, atol=2e-3)
    np.testing.assert_allclose(o.fused_pos.numpy(), jo.fused_pos, atol=1e-3)
    np.testing.assert_allclose(pipe.state.pose.numpy(), runs["jax_pose"], atol=1e-2)
    assert abs(int(pipe.state.map_state.count) - runs["jax_map_count"]) <= \
        0.01 * runs["jax_map_count"]


# ------------------------------------------------------------ lazy mode
def _frames(n):
    """The scene's frames, rendered by the port's own renderer."""
    layers = tsynth.scene_layers(4.0, 0)
    cam = online_config(tcfg).camera
    return [tsynth.render_frame(cam, None, *tsynth.trajectory(k / ONLINE_SCENE["fps"],
                                                              period=ONLINE_SCENE["period"]),
                                depth=4.0, layers=layers).astype(np.float32)
            for k in range(n)]


def test_lazy_matches_sync_exactly():
    """Without loops the deferred path publishes exactly the synchronous
    trajectory and fused track (the same steps on the same inputs, only
    the reads come later)."""
    cfg = online_config(tcfg, enable_loop_closure=False)
    frames = _frames(7)
    sync = SlamPipeline(cfg, device="cpu", seed=0)
    lazy = SlamPipeline(cfg, device="cpu", seed=0, lazy_depth=3)
    fused = []
    for k, f in enumerate(frames):
        sync.process_frame(f, 0.1 * k)
        fused.append(sync.last_output.fused_pos)
        assert lazy.process_frame(f, 0.1 * k) is None
    outs = [p[3] for p in lazy._pending]
    lazy.flush()
    assert len(lazy.trajectory) == len(sync.trajectory) == 7
    np.testing.assert_array_equal(np.stack([T for _, T in lazy.trajectory]),
                                  np.stack([T for _, T in sync.trajectory]))
    np.testing.assert_array_equal(torch.stack([o.fused_pos for o in outs]).numpy(),
                                  torch.stack(fused[-3:]).numpy())
    assert int(lazy.state.map_state.count) == int(sync.state.map_state.count) > 0


def test_lazy_loop_rebases_to_newest_node():
    """A loop popped from the deferred queue rebases the running pose onto
    the NEWEST dispatched node (frames after the loop's query frame
    already exist), and the frames dispatched before it are published
    from the optimised graph."""
    cfg = online_config(tcfg)
    lazy = SlamPipeline(cfg, device="cpu", seed=ONLINE_SEED, lazy_depth=3)
    loops_seen = 0
    for k, f in enumerate(_frames(ONLINE_SCENE["num_frames"])):
        lazy.process_frame(f, 0.1 * k)
        if lazy.num_loops > loops_seen:
            loops_seen = lazy.num_loops
            newest = len(lazy.trajectory) + len(lazy._pending)
            np.testing.assert_allclose(lazy.state.pose.numpy(),
                                       tpg.get_pose(lazy.state.graph, newest).numpy(),
                                       atol=1e-6)
            # the popped loop frame was published from the optimised graph
            node = len(lazy.trajectory)
            np.testing.assert_array_equal(lazy.trajectory[-1][1],
                                          tpg.get_pose(lazy.state.graph, node).numpy())
    lazy.finalize()
    assert loops_seen >= 1, "the revisit never closed a loop"
    assert np.isfinite(np.stack([T for _, T in lazy.trajectory])).all()


def test_lazy_flush_on_finalize():
    frames = _frames(5)
    lazy = SlamPipeline(online_config(tcfg, enable_loop_closure=False), device="cpu",
                        lazy_depth=4)
    for k, f in enumerate(frames):
        lazy.process_frame(f, 0.1 * k)
    assert len(lazy.trajectory) < len(frames)
    lazy.finalize()
    assert len(lazy.trajectory) == len(frames)
    assert np.isfinite(np.stack([T for _, T in lazy.trajectory])).all()
