"""Loop closure on the port's chunked evaluator (on the CPU, through the
match kernel's plain version) against the JAX package: the keyframe ring
DB, the histogram prefilter with its tie order, the exact candidate
scores, the batched geometric verification on random-descriptor
revisits with the JAX draws, the parallax weight, and a rendered
revisit end to end through both ChunkedSlams, from the start and from
the JAX snapshot.

One JAX ChunkedSlam pays the compile once: its jitted lc_query and
verify_batch serve the module tests at the end-to-end shapes."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aria_slam_tpu import config as jcfg
from aria_slam_tpu.backend import keyframe_db as jkdb
from aria_slam_tpu.backend import loop_closure as jlc
from aria_slam_tpu.core.types import KeyframeDB as JaxKeyframeDB, PoseDelta as JaxPoseDelta
from aria_slam_tpu.eval.chunked import ChunkedSlam as JaxChunkedSlam
from aria_slam_tpu.ops import epipolar as jep
from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch import convert
from aria_slam_tpu_torch.backend import keyframe_db as tkdb
from aria_slam_tpu_torch.backend import loop_closure as tlc
from aria_slam_tpu_torch.core.types import KeyframeDB, PoseDelta
from aria_slam_tpu_torch.eval import chunked as tch
from aria_slam_tpu_torch.eval.chunked import ChunkedSlam
from aria_slam_tpu_torch.ops import epipolar as tep

from torch_parity_util import (
    JaxChunkChainSampler, JaxPairsSampler, chunk_scene, small_config, to_np,
)

# The sweep at a 4 s period and 5 fps passes the origin every 10 frames
# with the same pose, so frame 20 revisits frame 10. The 16-slot ring
# wraps in the fourth chunk, whose insert overwrites candidate slots
# that its own query saw. Chunk BA and the IMU metric scale are off
# (the gyro priors stay) and the final optimisation runs 10 iterations,
# to keep the file near a minute: the odometry path has its tests in
# test_torch_chunked.py. With this seed both packages accept the same
# loops.
CHUNK = 5
NCHUNKS = 4
FPS = 5.0
PERIOD = 4.0
SEED = 2
SNAP_AFTER = 3  # chunks before the snapshot the converted run starts from


def _cfg(module):
    return small_config(
        module, enable_loop_closure=True, chunk_ba=module.ChunkBaConfig(enabled=False),
        imu_metric_scale=False,
        pose_graph=module.PoseGraphConfig(max_nodes=64, max_edges=128, lm_iterations=5,
                                          cg_iterations=24, final_lm_iterations=10),
        loop=module.LoopClosureConfig(max_keyframes=16, min_frames_between=10,
                                      min_score=0.3, min_matches=40))


JCFG = _cfg(jcfg)
TCFG = _cfg(tcfg)
CAP = TCFG.loop.max_keyframes
NF = TCFG.orb.num_features
K_NP = np.asarray(TCFG.camera.K, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


# the JAX functions held against, jitted: one compile each, not one a primitive
_jax_insert = jax.jit(jkdb.add_keyframes_batch)
_jax_prefilter = jax.jit(jlc.batch_candidates, static_argnums=3)
_jax_parallax = jax.jit(jep.mean_parallax_deg)


def _tdb(jdb):
    j = to_np(jdb)
    return KeyframeDB(**{name: _t(getattr(j, name)) for name in KeyframeDB.__dataclass_fields__})


def _assert_db_equal(jdb, tdb):
    j = to_np(jdb)
    for name in JaxKeyframeDB.__dataclass_fields__:
        np.testing.assert_array_equal(getattr(j, name), getattr(tdb, name).numpy(), err_msg=name)


# ------------------------------------------------------------------ inputs
def _batch(rng, c, start):
    """c random keyframes: descriptors, keypoints, masks, frame ids, poses."""
    poses = np.tile(np.eye(4, dtype=np.float32), (c, 1, 1))
    poses[:, :3, 3] = rng.normal(size=(c, 3))
    return (rng.integers(0, 2, (c, NF, 256)).astype(np.int8),
            rng.uniform(0, 320, (c, NF, 2)).astype(np.float32),
            rng.random((c, NF)) > 0.1, np.arange(start, start + c, dtype=np.int32), poses)


def _project(scene_w, T_wc):
    """Pixels of world points in the camera T_wc (small camera) and depths."""
    Tinv = np.linalg.inv(T_wc)
    Xc = scene_w @ Tinv[:3, :3].T + Tinv[:3, 3]
    uv = Xc[:, :2] / Xc[:, 2:3] * [K_NP[0, 0], K_NP[1, 1]] + [K_NP[0, 2], K_NP[1, 2]]
    return uv.astype(np.float32), Xc[:, 2].astype(np.float32)


def _yaw(deg, t):
    T = np.eye(4, dtype=np.float64)
    a = np.deg2rad(deg)
    T[:3, :3] = [[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]]
    T[:3, 3] = t
    return T


def _revisit_inputs(rng):
    """A DB of 16 random-descriptor scenes seen from the origin and a
    chunk of query frames (tests/test_loop_closure.py's construction at
    the small camera): a wide-baseline revisit, a zero-baseline yawed
    one, a novel place, a 35-degree revisit with a metre of translation
    and a small shift, each with 2 % of its bits flipped."""
    scenes = rng.uniform([-4, -3, 4], [4, 3, 12], size=(CAP, NF, 3))
    desc = rng.integers(0, 2, (CAP, NF, 256)).astype(np.int8)
    xy = np.stack([_project(s, np.eye(4))[0] for s in scenes])
    db = jkdb.init_db(JCFG.loop, JCFG.orb)
    db = _jax_insert(db, jnp.asarray(desc), jnp.asarray(xy), jnp.ones((CAP, NF), bool),
                     jnp.arange(CAP, dtype=jnp.int32), jnp.tile(jnp.eye(4)[None], (CAP, 1, 1)))
    views = [(2, _yaw(0, [0.3, 0.0, 0.1])), (5, _yaw(10, [0.002, -0.001, 0.001])),
             (None, np.eye(4)), (7, _yaw(35, [1.0, 0.2, 0.5])), (9, _yaw(3, [0.1, 0.05, 0.0]))]
    q_desc, q_xy, q_z = [], [], []
    for slot, T in views:
        scene = rng.uniform([-4, -3, 4], [4, 3, 12], (NF, 3)) if slot is None else scenes[slot]
        d = (rng.integers(0, 2, (NF, 256)).astype(np.int8) if slot is None
             else desc[slot].copy())
        d[rng.random(d.shape) < 0.02] ^= 1
        uv, z = _project(scene, T)
        q_desc.append(d)
        q_xy.append(uv)
        q_z.append(z)
    dvalid = rng.random((CHUNK, NF)) > 0.05
    m2 = rng.random((CHUNK, NF)) > 0.3
    z2 = np.where(m2, np.stack(q_z) / 2.0, 0.0).astype(np.float32)
    scales = np.array([2.0, 1.5, 1.0, 2.2, 0.8], np.float32)
    # 16 verify pairs: each query with its place (the novel one with any
    # slot), wrong pairs, the padding rows
    fidx = np.array([0, 1, 2, 3, 4, 0, 1, 3, 4, 2, 0, 0, 0, 0, 0, 0], np.int32)
    slots = np.array([2, 5, 3, 7, 9, 5, 2, 8, 10, 11, 0, 0, 0, 0, 0, 0], np.int32)
    return db, np.stack(q_desc), np.stack(q_xy), dvalid, z2, m2, scales, fidx, slots


# --------------------------------------------------------- the JAX run
@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The rendered revisit through both ChunkedSlams with loop closure
    on, the port drawing the JAX run's samples (the front end's and the
    verification's), then finalize; and the port once more from the JAX
    snapshot after SNAP_AFTER chunks."""
    frames, ts, gt, _, Rg, okg = chunk_scene(NCHUNKS * CHUNK + 1, FPS, PERIOD)
    js = JaxChunkedSlam(JCFG, chunk=CHUNK, seed=SEED)
    tslam = ChunkedSlam(TCFG, chunk=CHUNK, device="cpu",
                        sampler=JaxChunkChainSampler(jax.random.key(SEED), js.lag))
    js.lc_diag, tslam.lc_diag = [], []
    snap = str(tmp_path_factory.mktemp("snap") / "loop.npz")
    chunks = [(frames[s:s + CHUNK + 1], ts[s:s + CHUNK + 1], Rg[s:s + CHUNK], okg[s:s + CHUNK])
              for s in range(0, NCHUNKS * CHUNK, CHUNK)]
    res = dict(gt=gt, js=js, chunks=chunks)
    for k, args in enumerate(chunks):
        if k == SNAP_AFTER:
            js.snapshot(snap)
            key_after = js._key
        js.process_chunk(*args)
        tslam.process_chunk(*args)
    res["pairs"] = (list(js.loop_pairs), list(tslam.loop_pairs))
    res["num_loops"] = (js.num_loops, tslam.num_loops)
    res["dbs"] = (to_np(js.db), tslam.db)
    res["diag"] = (js.lc_diag, tslam.lc_diag)
    js.finalize()
    tslam.finalize()
    res["final"] = (np.stack([T for _, T in js.trajectory]),
                    np.stack([T for _, T in tslam.trajectory]))

    state = dict(np.load(snap))
    conv = ChunkedSlam(TCFG, chunk=CHUNK, device="cpu",
                       sampler=JaxChunkChainSampler(key_after, js.lag))
    convert.chunked_state_from_numpy(conv, state)
    # copies: the port's inserts write into the DB's buffers
    res["converted_db"] = (state, conv.db.map(torch.clone), conv._db_head)
    for args in chunks[SNAP_AFTER:]:
        conv.process_chunk(*args)
    res["converted"] = (list(conv.loop_pairs), conv.num_loops)
    return res


# ------------------------------------------------------- keyframe DB
def test_keyframe_db_inserts_wrap_and_links_match_jax():
    """add_keyframes_batch over four chunks of 5 into the 16-slot ring
    (the fourth wraps and evicts), then mark_covisible: every field
    exactly as the JAX package's, after every call."""
    rng = np.random.default_rng(0)
    jdb = jkdb.init_db(JCFG.loop, JCFG.orb)
    tdb = tkdb.init_db(TCFG.loop, TCFG.orb, "cpu")
    _assert_db_equal(jdb, tdb)
    for k in range(4):
        desc, xy, valid, fids, poses = _batch(rng, 5, 1 + k * 5)
        jdb = _jax_insert(jdb, *(jnp.asarray(a) for a in (desc, xy, valid, fids, poses)))
        tdb = tkdb.add_keyframes_batch(tdb, *(_t(a) for a in (desc, xy, valid, fids, poses)))
        _assert_db_equal(jdb, tdb)
    assert int(tdb.size) == CAP and int(tdb.head) == 4 and int(tdb.frame_id[0]) == 17
    for a, b in ((3, 9), (0, 15)):
        jdb = jkdb.mark_covisible(jdb, a, b)
        tdb = tkdb.mark_covisible(tdb, a, b)
    _assert_db_equal(jdb, tdb)
    assert bool(tdb.covis[9, 3]) and bool(tdb.covis[15, 0])


def test_prefilter_slots_and_tie_order_match_jax():
    """batch_candidates against the JAX prefilter with ties on purpose:
    keyframes with identical histograms, a query equal to one of them,
    and gated-out slots (gap and empty) that all score -1. Slots exactly,
    lower slot first among equal values; sims within 1e-6."""
    rng = np.random.default_rng(1)
    desc, xy, valid, fids, poses = _batch(rng, 12, 0)
    desc[[2, 5, 9]] = desc[2]
    valid[[2, 5, 9]] = valid[2]
    jdb = _jax_insert(jkdb.init_db(JCFG.loop, JCFG.orb),
                      *(jnp.asarray(a) for a in (desc, xy, valid, fids, poses)))
    tdb = _tdb(jdb)
    hists = np.asarray(jdb.hist)[[2, 7, 0, 11, 4]].copy()
    hists[4] = rng.random(256)
    qfids = np.array([40, 15, 12, 25, 3], np.int32)  # frame 3: every slot gated out
    jsims, jslots = _jax_prefilter(jdb, jnp.asarray(hists), jnp.asarray(qfids), JCFG.loop)
    tsims, tslots = tlc.batch_candidates(tdb, _t(hists), _t(qfids), TCFG.loop)
    np.testing.assert_array_equal(np.asarray(jslots), tslots.numpy())
    np.testing.assert_allclose(np.asarray(jsims), tsims.numpy(), atol=1e-6)
    assert tslots[0, :3].tolist() == [2, 5, 9] and float(tsims[0, 0]) == 1.0
    assert (tsims[4] == -1.0).all() and tslots[4].tolist() == list(range(8))


def test_lc_query_scores_exactly_equal(run):
    """lc_query (prefilter and exact scores, one kNN-2 over the C x 8
    candidate pairs) against the JAX run's own jitted program on the
    same DB and chunk: slots exactly, sims within 1e-6, scores exactly
    equal."""
    rng = np.random.default_rng(2)
    db, q_desc, _, dvalid, *_ = _revisit_inputs(rng)
    hists = np.asarray(jkdb.descriptor_histogram(jnp.asarray(q_desc), jnp.asarray(dvalid)))
    fids = np.arange(30, 30 + CHUNK, dtype=np.int32)
    jsims, jslots, jscores = (np.asarray(x) for x in run["js"]._lc_query(
        db, jnp.asarray(hists), jnp.asarray(fids), jnp.asarray(q_desc), jnp.asarray(dvalid)))
    tsims, tslots, tscores = tch.lc_query(_tdb(db), _t(hists), _t(fids), _t(q_desc),
                                          _t(dvalid), TCFG)
    np.testing.assert_array_equal(jslots, tslots.numpy())
    np.testing.assert_allclose(jsims, tsims.numpy(), atol=1e-6)
    np.testing.assert_array_equal(jscores, tscores.numpy())
    assert jscores.max() > 0.5 and (jscores < 0.1).sum() > 10  # revisits and others


def test_verify_batch_matches_jax(run):
    """verify_batch on random-descriptor revisits, 16 padded pairs, the
    JAX run's own jitted program and draws: passed and inlier counts
    exactly, R within 1e-4, the metric translation within 1e-3 absolute
    (a zero-baseline revisit shrinks it toward 0, so no direction is
    compared), the parallax weights within 1e-3."""
    rng = np.random.default_rng(3)
    db, q_desc, q_xy, dvalid, z2, m2, scales, fidx, slots = _revisit_inputs(rng)
    key = jax.random.key(11)
    corr = 1.3
    jout = [np.asarray(x) for x in run["js"]._lc_verify_batch(
        db, jnp.asarray(q_desc), jnp.asarray(q_xy), jnp.asarray(dvalid), jnp.asarray(z2),
        jnp.asarray(m2), jnp.asarray(scales), jnp.asarray(fidx), jnp.asarray(slots), key,
        jnp.asarray(corr, jnp.float32))]
    tout = [x.numpy() for x in tch.verify_batch(
        _tdb(db), _t(q_desc), _t(q_xy), _t(dvalid), _t(z2), _t(m2), _t(scales),
        _t(fidx).long(), _t(slots).long(), JaxPairsSampler(key, len(fidx), 0),
        torch.tensor(corr, dtype=torch.float32), TCFG, _t(K_NP))]
    (jp, jn, jT, jw), (tp, tn, tT, tw) = jout, tout
    np.testing.assert_array_equal(jp, tp)
    np.testing.assert_array_equal(jn, tn)
    np.testing.assert_allclose(jT[:, :3, :3], tT[:, :3, :3], atol=1e-4)
    np.testing.assert_allclose(jT[:, :3, 3], tT[:, :3, 3], atol=1e-3)
    np.testing.assert_allclose(jw, tw, atol=1e-3)
    # the true revisits pass (the zero-baseline one through the
    # rotation-only rescue, with a weight of ~0), the others fail
    assert tp[:5].tolist() == [True, True, False, True, True] and not tp[5:10].any()
    assert tw[1] < 0.1 and tw[3] > 0.9


def test_parallax_batched_equals_pair_by_pair():
    """mean_parallax_deg and parallax_t_weight over a leading pair axis
    against pair by pair and against the JAX functions pair by pair:
    counts exactly, the parallax within 0.02 degrees (an arccos near 1 in
    float32 resolves about 0.01 degrees at a zero baseline), the weight
    within 0.02 / 0.8 of that."""
    rng = np.random.default_rng(4)
    scene = rng.uniform([-4, -3, 4], [4, 3, 12], (NF, 3))
    views = [_yaw(0, [0.3, 0, 0.1]), _yaw(10, [0.002, 0, 0]), _yaw(35, [1.0, 0.2, 0.5]),
             _yaw(2, [0.05, 0.0, 0.0])]
    xy1 = np.stack([_project(scene, np.eye(4))[0]] * 4)
    xy2 = np.stack([_project(scene, T)[0] for T in views])
    valid = rng.random((4, NF)) > 0.2
    inl = rng.random((4, NF)) > 0.1
    R = np.stack([np.linalg.inv(T)[:3, :3] for T in views]).astype(np.float32)
    t = np.stack([np.linalg.inv(T)[:3, 3] for T in views]).astype(np.float32)

    def delta(p=slice(None)):
        return PoseDelta(R=_t(R[p]), t=_t(t[p]), num_inliers=_t(inl[p].sum(-1)),
                         inlier_mask=_t(inl[p]), success=_t(np.ones(4, bool)[p]))

    K = _t(K_NP)
    par, cnt = tep.mean_parallax_deg(delta(), _t(xy1), _t(xy2), _t(valid), K)
    w = tep.parallax_t_weight(par)
    for p in range(4):
        one, c1 = tep.mean_parallax_deg(delta(p), _t(xy1[p]), _t(xy2[p]), _t(valid[p]), K)
        jd = JaxPoseDelta(R=jnp.asarray(R[p]), t=jnp.asarray(t[p]),
                          num_inliers=jnp.asarray(inl[p].sum()), inlier_mask=jnp.asarray(inl[p]),
                          success=jnp.asarray(True))
        jpar, jcnt = _jax_parallax(jd, jnp.asarray(xy1[p]), jnp.asarray(xy2[p]),
                                   jnp.asarray(valid[p]), jnp.asarray(K_NP))
        assert float(cnt[p]) == float(c1) == float(jcnt)
        np.testing.assert_allclose(float(par[p]), float(one), atol=0.02)
        np.testing.assert_allclose(float(par[p]), float(jpar), atol=0.02)
        np.testing.assert_allclose(float(w[p]), float(jep.parallax_t_weight(jpar)), atol=0.025)
        assert float(tep.parallax_t_weight(one)) == pytest.approx(float(w[p]), abs=0.025)
    assert float(w[1]) == 0.0 and float(w[2]) == 1.0


# ---------------------------------------------------------- end to end
def test_loops_end_to_end_match_jax(run):
    """The rendered revisit through both ChunkedSlams: the JAX run closes
    at least one loop, every one of them true (the two frames within
    0.5 m); the port accepts the same loop pairs; the DB's frame ids,
    size, head and covisibility (temporal and loop links) agree; the
    trajectories after finalize lie within 2 % of the path length."""
    gt = run["gt"]
    jpairs, tpairs = run["pairs"]
    assert len(jpairs) >= 1
    assert all(np.linalg.norm(gt[i] - gt[j]) < 0.5 for i, j in jpairs), jpairs
    assert tpairs == jpairs
    assert run["num_loops"][0] == run["num_loops"][1] == len(jpairs)
    jdb, tdb = run["dbs"]
    for name in ("frame_id", "size", "head", "covis"):
        np.testing.assert_array_equal(getattr(jdb, name), getattr(tdb, name).numpy(),
                                      err_msg=name)
    assert int(tdb.head) == NCHUNKS * CHUNK % CAP  # the ring wrapped
    # the query of the wrapping chunk saw slots its own insert overwrote
    assert any((d["cand_fid"] == -2).any() for d in run["diag"][1] if d["cand_fid"] is not None)
    tj, tt = run["final"]
    assert tj.shape == tt.shape == (NCHUNKS * CHUNK + 1, 4, 4) and np.isfinite(tt).all()
    path = np.linalg.norm(np.diff(gt, axis=0), axis=1).sum()
    err = np.linalg.norm(tj[:, :3, 3] - tt[:, :3, 3], axis=1)
    assert err.max() < 0.02 * path, (err.max(), path)


def test_loops_from_converted_jax_state(run):
    """The port started from the JAX snapshot after three chunks
    (chunked_state_from_numpy, the keyframe DB and its head included)
    and given the JAX key chain from there: the DB arrives field for
    field, and the run continues to the JAX run's loop pairs."""
    state, got_db, head = run["converted_db"]
    for name in JaxKeyframeDB.__dataclass_fields__:
        np.testing.assert_array_equal(state[f"db.{name}"], getattr(got_db, name).numpy(),
                                      err_msg=name)
    assert head == int(state["counters"][2]) == SNAP_AFTER * CHUNK % CAP
    assert run["converted"] == (run["pairs"][0], run["num_loops"][0])


def test_port_snapshot_with_loops_continues_identically(run, tmp_path):
    """The main path's state file: loop closure and mapping on, a port
    ChunkedSlam on its own seeded generator snapshots after SNAP_AFTER
    chunks (db.* with the covisibility, counters[2] = the ring's head,
    torch_rng, the map), a fresh one with another seed restores it, and
    both run the last chunk, which closes loops and wraps the ring: loop
    pairs, every DB field, the head, the map, the graph and the
    trajectory come out identical."""
    cfg = dataclasses.replace(TCFG, enable_mapping=True)
    a = ChunkedSlam(cfg, chunk=CHUNK, device="cpu", seed=SEED)
    for args in run["chunks"][:SNAP_AFTER]:
        a.process_chunk(*args)
    path = str(tmp_path / "loop.npz")
    a.snapshot(path)
    b = ChunkedSlam(cfg, chunk=CHUNK, device="cpu", seed=99)
    b.restore(path)
    counters = [a.frame_count, a.num_loops, a._db_head]
    assert [b.frame_count, b.num_loops, b._db_head] == counters
    for s in (a, b):
        s.process_chunk(*run["chunks"][SNAP_AFTER])
    assert a.loop_pairs and a.loop_pairs == b.loop_pairs and a.num_loops == b.num_loops
    assert a._db_head == b._db_head < counters[2]  # the ring wrapped
    for name in ("db", "map_state", "graph"):
        for f in dataclasses.fields(getattr(a, name)):
            assert torch.equal(getattr(getattr(a, name), f.name),
                               getattr(getattr(b, name), f.name)), (name, f.name)
    np.testing.assert_array_equal(np.stack([T for _, T in a.trajectory]),
                                  np.stack([T for _, T in b.trajectory]))
    with np.load(path) as f:
        assert {"db.desc", "db.covis", "torch_rng", "map_state.points"} <= set(f.files)
        assert f["counters"].tolist() == counters


@pytest.mark.parametrize("flag", ["enable_detection"])
def test_loop_closure_with_unported_flags_raises(flag):
    """Loop closure runs; with detection and dynamic filtering beside it
    (refused until the detector was ported) the evaluator builds its
    detector and keeps its keyframe DB."""
    ChunkedSlam(TCFG, chunk=CHUNK, device="cpu")
    det = tcfg.DetectorConfig(input_size=64, width_mult=0.25, max_detections=16)
    slam = ChunkedSlam(dataclasses.replace(TCFG, detector=det, enable_dynamic_filtering=True,
                                           **{flag: True}), chunk=CHUNK, device="cpu")
    assert slam._detector is not None and slam.db is not None


def test_match_against_slot_equals_pair_by_pair():
    """_match_against_slot over V verify pairs (one kNN-2 for all of them,
    one kernel launch on the card) gives each pair what a kNN-2 of that
    pair alone gives: the strict gate, and the keypoints gathered at the
    best index; the loose tier contains the strict one."""
    rng = np.random.default_rng(5)
    desc, xy, valid, fids, poses = _batch(rng, 6, 0)
    tdb = tkdb.add_keyframes_batch(tkdb.init_db(TCFG.loop, TCFG.orb, "cpu"),
                                   *(_t(a) for a in (desc, xy, valid, fids, poses)))
    zeros = torch.zeros(3, NF)
    q = tch.Features(xy=_t(xy[:3]), response=zeros, angle=zeros, octave=zeros.int(), size=zeros,
                     desc=_t(desc[[4, 1, 2]]), valid=_t(valid[:3]))
    slots = torch.tensor([4, 0, 2])
    xy_q, xy_t, ok, ok_loose = tlc._match_against_slot(q, tdb, slots, 0.7, 0.9)
    for v in range(3):
        b, s, i = tch.match_ops.match_top2(q.desc[v], tdb.desc[slots[v]],
                                           tdb.desc_valid[slots[v]])
        np.testing.assert_array_equal(xy_t[v].numpy(), tdb.xy[slots[v]][i.long()].numpy())
        np.testing.assert_array_equal(ok[v].numpy(),
                                      tch.match_ops.ratio_gate(q.valid[v], b, s, 0.7).numpy())
    assert bool(ok[0].sum() > 300) and bool((ok <= ok_loose).all())
    assert torch.equal(xy_q, q.xy)
