"""The port's multi-sequence and multi-device layer (on the CPU, through
the kernels' plain versions; gloo ranks started by parallel/mesh.spawn)
against the JAX package: match_scores_vs_database, the sharded keyframe
DB's top-k on meshes of 2 and 4 ranks, the batched pair front ends of
parallel/multiseq.py and eval/multi_eval.py with the JAX package's draws
replayed, and run_scenes on tests/test_multi_eval.py's two scenes, at one
rank against JAX and at two and four ranks against one.

The spawned ranks run functions of the port package only, on numpy
arrays and paths, so no child imports JAX; every JAX reference is
computed here, in the parent."""

import dataclasses
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aria_slam_tpu import config as jcfg
from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch.eval import multi_eval as tme
from aria_slam_tpu_torch.ops import match as tmatch
from aria_slam_tpu_torch.parallel import dryrun as tdryrun
from aria_slam_tpu_torch.parallel import mesh as tmesh, multiseq as tmultiseq
from aria_slam_tpu_torch.parallel import sharded_db as tsdb

from torch_parity_util import JaxPairsSampler, small_config

SPAWN_TIMEOUT_S = 120  # a hung rendezvous fails its test, not the run
RATIO, TOP_K = 0.7, 5


def _config(module, **orb):
    """tests/test_multi_eval.py's configuration (VO only, 384 features, 3
    levels, 128 hypotheses) without the homography rescue and the Sampson
    polish: the JAX front end's compile drops from about 27 s to 17 s (both
    paths are held against JAX in tests/test_torch_geometry.py and
    tests/test_torch_chunked.py)."""
    cfg = small_config(module)
    return dataclasses.replace(
        cfg, orb=dataclasses.replace(cfg.orb, **orb),
        ransac=dataclasses.replace(cfg.ransac, h_fallback=False, polish_iters=0))


JCFG = _config(jcfg)
TCFG = _config(tcfg)
CHUNK = 8
# the JAX key of the front-end comparisons. Many pairs of these scenes
# (10 fps, small baselines) have two consensus sets for the gyro-fused
# translation, and float32 rounding picks one (ROADMAP.md queue 3): with
# this key both packages take the same branch at every pair of every
# chunk round (with key 2, pair 5 of the second scene's second round
# lands 65 degrees apart).
SEED = 6


def _random_db(rng, n_kf=64, n_feat=96, n_bits=256):
    """tests/test_sharded_db.py's DB: {0,1} int8 descriptors, two planted
    revisits sharing 80 and 60 of the query's descriptors."""
    db_desc = rng.integers(0, 2, (n_kf, n_feat, n_bits)).astype(np.int8)
    db_valid = rng.random((n_kf, n_feat)) < 0.9
    q_desc = rng.integers(0, 2, (n_feat, n_bits)).astype(np.int8)
    q_valid = rng.random(n_feat) < 0.9
    hit_a, hit_b = n_kf // 6, n_kf // 2 + 5
    db_desc[hit_a, :80] = q_desc[:80]
    db_desc[hit_b, :60] = q_desc[:60]
    db_valid[hit_a, :80] = True
    db_valid[hit_b, :60] = True
    return (q_desc, q_valid, db_desc, db_valid), (hit_a, hit_b)


def _jax_scores(case):
    from aria_slam_tpu.ops.match import match_scores_vs_database

    q, vq, db, dbv = (jnp.asarray(x) for x in case)
    return np.asarray(match_scores_vs_database(q, vq, db, dbv, RATIO))


def _jax_topk(case):
    vals, idx = jax.lax.top_k(jnp.asarray(_jax_scores(case)), TOP_K)
    return np.asarray(vals), np.asarray(idx)


@pytest.fixture(scope="module")
def db_cases():
    rng = np.random.default_rng(42)
    planted, hits = _random_db(rng)
    # a DB of duplicated keyframes: every score appears twice (ties), and
    # the top-k must keep the lower global index first across shards
    q, vq, db, dbv = _random_db(rng, n_kf=32)[0]
    dup = (q, vq, np.concatenate([db, db]), np.concatenate([dbv, dbv]))
    return {"planted": planted, "dup": dup, "hits": hits}


def test_match_scores_vs_database_equals_jax(db_cases):
    """One query against 64 keyframes: the same scores (atol 1e-6, as
    tests/test_sharded_db.py; every score is an exact ratio of counts)."""
    for name in ("planted", "dup"):
        case = db_cases[name]
        got = tmatch.match_scores_vs_database(*(torch.from_numpy(x) for x in case), RATIO)
        np.testing.assert_allclose(got.numpy(), _jax_scores(case), rtol=0, atol=1e-6,
                                   err_msg=name)


GROUPS = {1: [], 2: [(1, 2)], 4: [(2, 2), (1, 4)]}  # world size: sharded-DB mesh shapes


def _train_batch():
    """Four random images at the dry run's detector size (64 px) and
    random targets shaped like its box maps (64 channels at strides 8,
    16, 32), NCHW float32."""
    rng = np.random.default_rng(8)
    return (rng.uniform(0, 1, (4, 3, 64, 64)).astype(np.float32),
            [rng.normal(0, 1, (4, 64, s, s)).astype(np.float32) for s in (8, 4, 2)])


@pytest.fixture(scope="module", autouse=True)
def _spawned(db_cases, scene_dirs):
    """Gloo groups of one, two and four ranks, each started once
    (parallel/mesh.run_jobs) when the module starts and waited for on
    threads of this process while the JAX programs below compile:
    sharded_topk_scores on meshes of 1 x 2, 2 x 2 and 1 x 4, run_scenes
    with the whole group as the data axis (at one and two ranks keeping
    the trajectories), the detector's data-parallel train step at one and
    two data ranks (parallel/dryrun.train_step_rank) and the dry run at two
    and four ranks (parallel/dryrun.run_rank)."""
    cases = [db_cases["planted"], db_cases["dup"]]
    q, vq, db, dbv = db_cases["planted"]
    train = (tdryrun.train_step_rank, _train_batch())
    extra = {1: [train], 2: [train, (tdryrun.run_rank, ())], 4: [(tdryrun.run_rank, ())]}
    with ThreadPoolExecutor(len(GROUPS) + 1) as pool:
        futs = {world: pool.submit(
            tmesh.spawn, tmesh.run_jobs, world, "gloo", timeout_s=SPAWN_TIMEOUT_S,
            args=([(tsdb.query_rank, (shapes, cases, RATIO, TOP_K)),
                   (tme.run_rank, (scene_dirs, TCFG, CHUNK, 0, False, world < 4))]
                  + extra[world],))
            for world, shapes in GROUPS.items()}
        # 63 keyframes on two model ranks: each rank raises
        futs["ragged"] = pool.submit(tmesh.spawn, tsdb.query_rank, 2, "gloo",
                                     timeout_s=SPAWN_TIMEOUT_S,
                                     args=([(1, 2)], [(q, vq, db[:63], dbv[:63])], RATIO, TOP_K))
        yield futs


@pytest.fixture(scope="module")
def ranks(_spawned):
    """Every rank's results: by mesh shape for the sharded DB, by world
    size for run_scenes, ("train", world) for the data-parallel train step
    and ("dryrun", world) for the dry run."""
    out = {}
    for world in GROUPS:
        res = _spawned[world].result()
        for j, shape in enumerate(GROUPS[world]):
            out[shape] = [r[0][j] for r in res]
        out[world] = [r[1] for r in res]
        if world < 4:
            out[("train", world)] = [r[2] for r in res]
        if world > 1:
            out[("dryrun", world)] = [r[-1] for r in res]
    return out


# ------------------------------------------------------- the front ends
@pytest.fixture(scope="module")
def scene_dirs(tmp_path_factory):
    """tests/test_multi_eval.py's two scenes, written by the JAX package's
    generator: 25 sweep frames each, periods 10 s and 14 s."""
    from aria_slam_tpu.io import synthetic_scene

    dirs = []
    for i, period in enumerate([10.0, 14.0]):
        out = tmp_path_factory.mktemp(f"mseq{i}")
        synthetic_scene.generate(str(out), num_frames=25, fps=10.0, cam=JCFG.camera, depth=4.0,
                                 traj="sweep", period=period, seed=i)
        dirs.append(str(out))
    return dirs


class JaxMultiSampler:
    """run_scenes' key chain in the JAX package: every chunk round splits
    the carried key into (key, sub) and the round's S * C pairs draw from
    split(sub, S * C) in (S, C) row-major order."""

    def __init__(self, seed):
        self.key = jax.random.key(seed)
        self.inner = None

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        if stage == "essential":
            self.key, sub = jax.random.split(self.key)
            self.inner = JaxPairsSampler(sub, valid.shape[0], 0)
        return self.inner(valid, num_hypotheses, sample_size, stage)


def _round(scene_dirs, k):
    """The inputs of run_scenes' chunk round from frame k: (S, C+1) uint8
    frames and the (S, C) gyro priors, through the port's reader and
    integrator (the last frame repeats past a sequence's end)."""
    from aria_slam_tpu_torch.fusion import gyro_prior
    from aria_slam_tpu_torch.io import euroc

    frames, gR, gok = [], [], []
    for d in scene_dirs:
        data = euroc.load(d)
        idx = [min(i, len(data.image_paths) - 1) for i in range(k, k + CHUNK + 1)]
        frames.append(np.stack([euroc.load_image(data.image_paths[i]) for i in idx]))
        r, ok = gyro_prior.pair_rotations(data.imu_ts, data.imu_gyro, data.image_ts[idx],
                                          R_cam_imu=data.R_cam_imu)
        gR.append(r.astype(np.float32))
        gok.append(ok)
    return np.stack(frames), np.stack(gR), np.stack(gok)


@pytest.fixture(scope="module")
def jax_front():
    """The JAX package's multi-sequence front end, compiled once a module
    (its run_scenes below reuses it)."""
    from aria_slam_tpu.eval import multi_eval as jme

    return jme.make_multi_chunk_frontend(JCFG, None)


def test_multi_chunk_frontend_equals_jax(scene_dirs, jax_front):
    """make_multi_chunk_frontend on the three chunk rounds of both scenes
    (S = 2, C = 8: 18 frames in one extract, 16 pairs in one RANSAC call),
    the port fed the JAX run's per-pair keys, against the JAX front end
    pair by pair, at the chunked parity gates (tests/test_torch_chunked.py):
    the same success and pin flags, rotations within 1e-3 (every pair has
    its gyro prior), translation directions within 3 degrees, pins within
    10 %."""
    sampler = JaxMultiSampler(SEED)
    jkey = jax.random.key(SEED)
    frontend = tme.make_multi_chunk_frontend(TCFG)
    for k in range(0, 24, CHUNK):
        frames, gR, gok = _round(scene_dirs, k)
        jkey, sub = jax.random.split(jkey)
        R, t, ok, pins, pin_oks = (np.asarray(x) for x in jax_front(
            jnp.asarray(frames), jax.random.split(sub, 2 * CHUNK), jnp.asarray(gR),
            jnp.asarray(gok)))
        got = [x.numpy() for x in frontend(torch.from_numpy(frames), sampler,
                                           torch.from_numpy(gR), torch.from_numpy(gok))]
        assert got[0].shape == (2, CHUNK, 3, 3)
        np.testing.assert_array_equal(got[2], ok, err_msg=f"round {k}")
        np.testing.assert_array_equal(got[4], pin_oks, err_msg=f"round {k}")
        np.testing.assert_allclose(got[0], R, atol=1e-3, err_msg=f"round {k}")
        cos = np.sum(got[1] * t, -1)
        assert cos.min() > np.cos(np.radians(3.0)), (k, cos)
        np.testing.assert_allclose(got[3], pins, rtol=0.1, err_msg=f"round {k}")


def test_batched_frontend_equals_jax(scene_dirs):
    """parallel/multiseq.batched_frontend (no gyro prior, no undistortion)
    on the second scene's 5 pairs (i, i + 4) of its first 9 frames with
    JAX's keys, both packages at one pyramid level (the JAX function's
    compile stays under 15 s):
    the same inlier counts within 10 %, rotations within 5e-3 and
    translation directions within 3 degrees; shard_batched_frontend on a
    one-rank mesh gives the port's result again. Without a gyro prior the
    consecutive pairs' translation is two-valued at this baseline
    (ROADMAP.md queue 3), so the pairs are four frames apart."""
    from aria_slam_tpu.parallel import multiseq as jmultiseq

    frames = _round(scene_dirs, 0)[0][1]
    img1, img2 = frames[:-4], frames[4:]
    key = jax.random.key(SEED)
    R, t, ninl = (np.asarray(x) for x in jax.jit(jmultiseq.batched_frontend(_config(jcfg, num_levels=1)))(
        jnp.asarray(img1), jnp.asarray(img2), jax.random.split(key, len(img1))))
    img1, img2 = torch.from_numpy(img1), torch.from_numpy(img2)
    gR, gt, gn = tmultiseq.batched_frontend(_config(tcfg, num_levels=1))(img1, img2,
                                                        JaxPairsSampler(key, len(img1), 0))
    np.testing.assert_allclose(gn.numpy(), ninl, rtol=0.1)
    np.testing.assert_allclose(gR.numpy(), R, atol=5e-3)
    assert np.sum(gt.numpy() * t, -1).min() > np.cos(np.radians(3.0))
    mesh = tmesh.Mesh(rank=0, shape={"data": 1, "model": 1}, data_group=None,
                      model_group=None, device=torch.device("cpu"))
    sR, _, sn = tmultiseq.shard_batched_frontend(mesh, _config(tcfg, num_levels=1))(
        img1, img2, JaxPairsSampler(key, len(img1), 0))
    assert torch.equal(sR, gR) and torch.equal(sn, gn)


# ------------------------------------------------------------ run_scenes
@pytest.fixture(scope="module")
def replay(scene_dirs):
    """run_scenes in this process with the JAX package's draws replayed."""
    return tme.run_scenes(scene_dirs, TCFG, chunk=CHUNK, verbose=False, device="cpu",
                          sampler=JaxMultiSampler(SEED))


def test_run_scenes_one_rank_against_jax(scene_dirs, replay, ranks, jax_front, monkeypatch):
    """Both scenes, 25 frames each: ATE finite and < 0.35 m (the gate of
    tests/test_multi_eval.py) with the port's own draws (one gloo rank)
    and with JAX's (in this process), the latter within 1e-3 m of the JAX
    package's run_scenes (mesh=None) on the same draws, and different
    between the two sequences."""
    from aria_slam_tpu.eval import multi_eval as jme

    monkeypatch.setattr(jme, "make_multi_chunk_frontend", lambda cfg, mesh: jax_front)
    want = jme.run_scenes(scene_dirs, JCFG, chunk=CHUNK, mesh=None, seed=SEED, verbose=False)
    own = ranks[1][0]
    for w, g, o in zip(want, replay, own):
        assert g["frames"] == w["frames"] == o["frames"] == 25
        assert g["skipped_images"] == w["skipped_images"] == 0
        for r in (g, o):
            assert np.isfinite(r["ate_rmse_m"]) and r["ate_rmse_m"] < 0.35, r
        assert abs(g["ate_rmse_m"] - w["ate_rmse_m"]) < 1e-3, (g, w)
    assert own[0]["ate_rmse_m"] != own[1]["ate_rmse_m"]


def test_run_scenes_two_ranks_equal_one_to_the_bit(scene_dirs, ranks):
    """Two gloo ranks, one sequence each: every rank returns both results,
    and each trajectory equals the one-rank run's (both sequences in one
    batch) to the last bit (each sequence draws from its own
    generator)."""
    for res in ranks[2]:
        assert [r["sequence"] for r in res] == scene_dirs
        for r, o in zip(res, ranks[1][0]):
            np.testing.assert_array_equal(r["trajectory"], o["trajectory"])
            assert r["ate_rmse_m"] == o["ate_rmse_m"]


def test_run_scenes_pads_sequences_to_the_mesh(scene_dirs, ranks):
    """S = 2 on four ranks: the padded slots (copies of the last sequence)
    are placeholders; every rank returns exactly the 2 results, equal to
    the one-rank run's."""
    for res in ranks[4]:
        assert len(res) == 2
        for r, o in zip(res, ranks[1][0]):
            assert r["frames"] == 25 and r["ate_rmse_m"] == o["ate_rmse_m"]


def test_run_scenes_rejects_mixed_cameras(scene_dirs, tmp_path):
    from aria_slam_tpu_torch.io import synthetic_scene

    other = dataclasses.replace(TCFG.camera, fx=TCFG.camera.fx * 1.3)
    out = str(tmp_path / "othercam")
    synthetic_scene.generate(out, num_frames=5, fps=10.0, cam=other, depth=4.0, traj="sweep",
                             period=10.0, seed=7)
    with pytest.raises(ValueError, match="intrinsics"):
        tme.run_scenes([scene_dirs[0], out], TCFG, chunk=4, verbose=False, device="cpu")


# ----------------------------------------------------- the sharded DB
@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (1, 4)])
def test_sharded_topk_equals_jax_single_device(db_cases, ranks, shape):
    """Every rank returns JAX's single-device lax.top_k exactly: the same
    winners in the same order, ties included (lower index first), each
    score the single-device score of its index; the planted revisits are
    among them."""
    for name, k in (("planted", 0), ("dup", 1)):
        want_v, want_i = _jax_topk(db_cases[name])
        ref = _jax_scores(db_cases[name])
        for rank, res in enumerate(ranks[shape]):
            vals, idx = res[k]
            np.testing.assert_array_equal(idx, want_i, err_msg=f"{name} rank {rank}")
            np.testing.assert_allclose(vals, want_v, rtol=0, atol=1e-6)
            np.testing.assert_allclose(vals, ref[idx], rtol=0, atol=1e-6)
        if name == "planted":
            assert set(db_cases["hits"]) <= set(ranks[shape][0][0][1].tolist())


def test_sharded_db_needs_a_multiple_of_the_model_axis(_spawned):
    """63 keyframes on two model ranks: each rank raises ValueError, and
    spawn fails the call with a rank's traceback."""
    with pytest.raises(RuntimeError, match="(?s)mesh rank.*ValueError.*does not split"):
        _spawned["ragged"].result()


# ------------------------------------------------ the detector's DP step
def test_dp_train_step_two_ranks_equal_one(ranks):
    """make_sharded_train_step on two gloo data ranks, two images each,
    against one rank on all four (a float32 model, one SGD(1e-3) step from
    init_model): the same loss, parameters and batch-norm running
    statistics on both ranks within 1e-5. The statistics are the whole
    batch's because batch norm sums them over the data group; with each
    rank's own statistics the running means would differ by the two
    halves' spread."""
    one = ranks[("train", 1)][0]
    two = ranks[("train", 2)]
    for res in two:
        assert abs(res["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"])
        assert set(res["state"]) == set(one["state"])
        for k, w in one["state"].items():
            np.testing.assert_allclose(res["state"][k], w, rtol=0, atol=1e-5, err_msg=k)
    # the step did train: the stem's running mean moved off its zero start
    assert np.abs(one["state"]["YoloBackboneNeck_0.ConvBnAct_0.BatchNorm_0.mean"]).max() > 1e-4


@pytest.mark.parametrize("world", [2, 4])
def test_dry_run_completes(ranks, world):
    """parallel/dryrun.run_rank on two ranks (mesh 1 x 2) and four (2 x 2):
    every part ran on every rank, the data-parallel loss is finite and the
    same on every rank, the DB query's top-3 is the same on every rank,
    and the front ends return every data rank's rows."""
    res = ranks[("dryrun", world)]
    n_data = world // 2
    for r in res:
        assert r["mesh"] == (n_data, 2)
        assert np.isfinite(r["loss"]) and r["loss"] == res[0]["loss"]
        assert r["db_top"] == res[0]["db_top"] and len(r["db_top"]) == 3
        assert r["pairs_R"].shape == (n_data, 3, 3)
        assert r["chunk_R"].shape == (n_data, 3, 3, 3)
