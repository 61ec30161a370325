"""The chunked evaluator's back-end modules of the port against the JAX
package on the same numpy-seeded inputs: descriptor histogram, track
building, gyro priors, the batched pose-graph updates, chunk bundle
adjustment, IMU preintegration, the visual-inertial alignment and the
scale estimator, plus the port's own stage timer and packed fetch."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aria_slam_tpu import config as jcfg
from aria_slam_tpu.backend import chunk_ba as jba
from aria_slam_tpu.backend import keyframe_db as jkdb
from aria_slam_tpu.backend import pose_graph as jpg
from aria_slam_tpu.core import lie as jlie
from aria_slam_tpu.fusion import gyro_prior as jgyro
from aria_slam_tpu.fusion import preintegration as jpre
from aria_slam_tpu.fusion import vi_init as jvi
from aria_slam_tpu.ops import epipolar as jep
from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch.backend import chunk_ba as tba
from aria_slam_tpu_torch.backend import keyframe_db as tkdb
from aria_slam_tpu_torch.backend import pose_graph as tpg
from aria_slam_tpu_torch.core import lie as tlie
from aria_slam_tpu_torch.eval.chunked import fetch_many
from aria_slam_tpu_torch.fusion import gyro_prior as tgyro
from aria_slam_tpu_torch.fusion import preintegration as tpre
from aria_slam_tpu_torch.fusion import vi_init as tvi
from aria_slam_tpu_torch.io import synthetic_scene as tsynth
from aria_slam_tpu_torch.ops import epipolar as tep
from aria_slam_tpu_torch.utils.profiling import StageTimer

import torch_parity_util  # noqa: F401 (caps torch's threads for the shared runners)

K_NP = jcfg.CameraConfig().K


def _t(x):
    return torch.from_numpy(np.array(x))


def test_descriptor_histogram_exact():
    rng = np.random.default_rng(0)
    desc = rng.integers(0, 2, (3, 40, 256)).astype(np.int8)
    valid = rng.random((3, 40)) > 0.3
    valid[2] = False  # an empty frame divides by 1, not 0
    ref = np.asarray(jkdb.descriptor_histogram(jnp.asarray(desc), jnp.asarray(valid)))
    got = tkdb.descriptor_histogram(_t(desc), _t(valid)).numpy()
    np.testing.assert_array_equal(ref, got)  # sums of 0/1 are exact in any order


def test_quaternion_ops_match():
    """The quaternion helpers preintegration needs, within 1e-6."""
    rng = np.random.default_rng(1)
    phi = rng.normal(0, 0.5, (7, 3)).astype(np.float32)
    phi[0] = 0.0  # the small-angle branch
    v = rng.normal(size=(7, 3)).astype(np.float32)
    qj, qt = jlie.so3_exp_quat(jnp.asarray(phi)), tlie.so3_exp_quat(_t(phi))
    np.testing.assert_allclose(np.asarray(qj), qt.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jlie.quat_to_mat(qj)), tlie.quat_to_mat(qt).numpy(),
                               atol=1e-6)
    np.testing.assert_allclose(np.asarray(jlie.quat_rotate(qj, jnp.asarray(v))),
                               tlie.quat_rotate(qt, _t(v)).numpy(), atol=1e-6)
    np.testing.assert_allclose(np.asarray(jlie.quat_mul(qj, qj[::-1])),
                               tlie.quat_mul(qt, qt.flip(0)).numpy(), atol=1e-6)
    np.testing.assert_array_equal(np.asarray(jlie.quat_identity((2,))),
                                  tlie.quat_identity((2,), device="cpu").numpy())


def test_gyro_pair_rotations_exact():
    ti, _, gyro = tsynth.imu_samples(2.0)
    ts = np.arange(0, 11) / 5.0
    ts[7] = ts[6]  # a repeated frame time gives an invalid pair
    R_ci = np.asarray(jlie.so3_exp(jnp.asarray([0.1, -0.2, 0.3], jnp.float32)), np.float64)
    for kw in ({}, {"R_cam_imu": R_ci, "gyro_bias": np.array([1e-3, 0.0, -2e-3])}):
        Rj, vj = jgyro.pair_rotations(ti, gyro, ts, **kw)
        Rt, vt = tgyro.pair_rotations(ti, gyro, ts, **kw)
        np.testing.assert_array_equal(Rj, Rt)
        np.testing.assert_array_equal(vj, vt)
    assert vt.sum() == 9 and not vt[6]


def _chain(rng, n):
    poses, rels, T = [], [], np.eye(4, dtype=np.float32)
    for _ in range(n):
        rel = np.asarray(jlie.se3_exp(jnp.asarray(0.1 * rng.normal(size=6), jnp.float32)))
        T = T @ rel
        poses.append(T.copy())
        rels.append(rel)
    return np.stack(poses), np.stack(rels)


@pytest.mark.parametrize("max_edges", [32, 9], ids=["fits", "overflows"])
def test_extend_chain_and_add_edges_batch_match(max_edges):
    """Two chain extensions and a batch of backbone edges, every graph
    field within 1e-6; with 9 edge slots the 14 edges overflow and the
    surplus is dropped as the reference drops it."""
    rng = np.random.default_rng(2)
    kw = dict(max_nodes=12, max_edges=max_edges)
    jc, tc = jcfg.PoseGraphConfig(**kw), tcfg.PoseGraphConfig(**kw)
    gj = jpg.set_node(jpg.init_graph(jc), 0, jnp.eye(4))
    gt = tpg.set_node(tpg.init_graph(tc, "cpu"), 0, torch.eye(4))
    poses, rels = _chain(rng, 10)
    for first, n, twt, rwt in ((1, 6, 1.0, 25.0), (7, 4, 0.5, 1.0)):
        sl = slice(first - 1, first - 1 + n)
        gj = jpg.extend_chain(gj, jnp.asarray(poses[sl]), jnp.asarray(rels[sl]), first, twt,
                              jnp.asarray(rwt, jnp.float32))
        gt = tpg.extend_chain(gt, _t(poses[sl]), _t(rels[sl]), first, twt, rwt)
    i_idx = np.arange(0, 4, dtype=np.int32)
    valid = np.array([True, False, True, True])
    brel = _chain(rng, 4)[1]
    gj = jpg.add_edges_batch(gj, jnp.asarray(i_idx), jnp.asarray(i_idx + 4), jnp.asarray(brel),
                             2.0, jnp.asarray(valid))
    gt = tpg.add_edges_batch(gt, _t(i_idx), _t(i_idx + 4), _t(brel), 2.0, _t(valid))
    for f in tpg.PoseGraph.__dataclass_fields__:
        np.testing.assert_allclose(np.asarray(getattr(gj, f)), getattr(gt, f).numpy(),
                                   atol=1e-6, err_msg=f)
    assert int(gt.num_edges) == min(14, max_edges) and int(gt.num_nodes) == 11


def _ba_scene(seed, f=6, n=96):
    """f cameras sweeping past n points: noisy chained poses, keypoints in
    a different slot order every frame, match links with outlier flags and
    two forced duplicate targets a pair."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-3, 3, n), rng.uniform(-2, 2, n), rng.uniform(3, 8, n)], -1)
    poses_true, poses_init = [], []
    for i in range(f):
        xi = np.r_[0.15 * i, 0.02 * np.sin(i), 0.01 * i, 0.0, 0.02 * i, 0.0]
        T = np.asarray(jlie.se3_exp(jnp.asarray(xi, jnp.float32)), np.float64)
        poses_true.append(T)
        noise = np.r_[rng.normal(0, 0.03, 3), rng.normal(0, 0.004, 3)] * (i > 0)
        poses_init.append(T @ np.asarray(jlie.se3_exp(jnp.asarray(noise, jnp.float32))))
    perms = [rng.permutation(n) for _ in range(f)]
    fxy = np.zeros((f, n, 2), np.float32)
    for i, (T, perm) in enumerate(zip(poses_true, perms)):
        Xc = (X[perm] - T[:3, 3]) @ T[:3, :3]
        uv = Xc[:, :2] / Xc[:, 2:3] * [K_NP[0, 0], K_NP[1, 1]] + [K_NP[0, 2], K_NP[1, 2]]
        fxy[i] = uv + rng.normal(0, 0.2, uv.shape)
    fvalid = rng.random((f, n)) > 0.05
    midx = np.zeros((f - 1, n), np.int32)
    for i in range(f - 1):
        inv = np.argsort(perms[i])
        midx[i] = inv[perms[i + 1]]
        midx[i, 5], midx[i, 40] = midx[i, 9], midx[i, 2]   # duplicate targets
    cinl = rng.random((f - 1, n)) > 0.1
    cinl[:, [5, 9, 40, 2]] = True
    return (np.stack(poses_init).astype(np.float32), fxy, fvalid, midx, cinl,
            np.stack(poses_true).astype(np.float32))


def test_build_tracks_exact():
    _, _, _, midx, cinl, _ = _ba_scene(3)
    ref = np.asarray(jba.build_tracks(jnp.asarray(midx), jnp.asarray(cinl), midx.shape[1]))
    got = tba.build_tracks(_t(midx), _t(cinl), midx.shape[1]).numpy()
    np.testing.assert_array_equal(ref, got)
    # of two slots with one target the lower keeps the track, the other starts one
    n = midx.shape[1]
    assert got[1, 5] == got[0, midx[0, 5]] and got[1, 9] == n + 9


def test_triangulate_tracks_matches():
    """World points of every track with two or more observations within
    1e-3 (absolute, metres), the observation counts exactly."""
    poses, fxy, fvalid, midx, cinl, _ = _ba_scene(4)
    f, n = fvalid.shape
    ids = np.asarray(jba.build_tracks(jnp.asarray(midx), jnp.asarray(cinl), n))
    w = fvalid.astype(np.float32)
    Xj, cj = jba.triangulate_tracks(jnp.asarray(poses), jnp.asarray(fxy), jnp.asarray(w),
                                    jnp.asarray(ids), jnp.asarray(K_NP), f * n)
    Xt, ct = tba.triangulate_tracks(_t(poses), _t(fxy), _t(w), _t(ids).long(), _t(K_NP), f * n)
    np.testing.assert_array_equal(np.asarray(cj), ct.numpy())
    multi = ct.numpy() >= 2
    assert multi.sum() > 50
    np.testing.assert_allclose(np.asarray(Xj)[multi], Xt.numpy()[multi], atol=1e-3)


@pytest.mark.parametrize("rot_scale", [1.0, 0.0], ids=["free", "gyro_rotations"])
def test_refine_matches(rot_scale):
    """chunk_ba.refine: poses within 1e-3, reprojection errors within 1e-2
    px, the depth pin statistic within 1e-3 relative, its count exact; and
    the refinement moves the poses toward the truth."""
    poses, fxy, fvalid, midx, cinl, truth = _ba_scene(5)
    jc, tc = jcfg.ChunkBaConfig(), tcfg.ChunkBaConfig()
    ref = jba.refine(jnp.asarray(poses), jnp.asarray(fxy), jnp.asarray(fvalid),
                     jnp.asarray(midx), jnp.asarray(cinl), jnp.asarray(K_NP), jc,
                     jnp.asarray(rot_scale, jnp.float32))
    got = tba.refine(_t(poses), _t(fxy), _t(fvalid), _t(midx), _t(cinl), _t(K_NP), tc, rot_scale)
    np.testing.assert_allclose(np.asarray(ref[0]), got[0].numpy(), atol=1e-3)
    np.testing.assert_allclose(float(ref[1]), float(got[1]), atol=1e-2)
    np.testing.assert_allclose(float(ref[2]), float(got[2]), atol=1e-2)
    np.testing.assert_allclose(float(ref[3]), float(got[3]), rtol=1e-3)
    assert float(ref[4]) == float(got[4]) > 20
    assert float(got[2]) < 0.5 * float(got[1])
    if rot_scale == 0.0:
        np.testing.assert_allclose(got[0][:, :3, :3].numpy(), poses[:, :3, :3], atol=1e-6)


def test_pose_step_matches():
    poses, fxy, fvalid, midx, cinl, _ = _ba_scene(6)
    f, n = fvalid.shape
    ids = np.asarray(jba.build_tracks(jnp.asarray(midx), jnp.asarray(cinl), n))
    w = fvalid.astype(np.float32)
    X, _ = jba.triangulate_tracks(jnp.asarray(poses), jnp.asarray(fxy), jnp.asarray(w),
                                  jnp.asarray(ids), jnp.asarray(K_NP), f * n)
    X_obs = np.asarray(X)[ids]
    ref = jba._pose_step(jnp.asarray(poses), jnp.asarray(poses), jnp.asarray(X_obs),
                         jnp.asarray(fxy), jnp.asarray(w), jnp.asarray(K_NP), jcfg.ChunkBaConfig())
    got = tba._pose_step(_t(poses), _t(poses), _t(X_obs), _t(fxy), _t(w), _t(K_NP),
                         tcfg.ChunkBaConfig())
    np.testing.assert_allclose(np.asarray(ref), got.numpy(), atol=1e-4)


def test_masked_log_median_matches():
    rng = np.random.default_rng(7)
    z = np.exp(rng.normal(1.0, 0.8, 500)).astype(np.float32)
    for mask in (rng.random(500) > 0.4, np.zeros(500, bool)):
        ref = jep.masked_log_median(jnp.asarray(z), jnp.asarray(mask))
        got = tep.masked_log_median(_t(z), _t(mask))
        np.testing.assert_allclose(float(ref[0]), float(got[0]), rtol=1e-5)
        assert float(ref[1]) == float(got[1])


def test_integrate_with_covariance_matches():
    """One preintegration state through 12 samples, covariance included,
    within 1e-5 (1e-4 relative on P)."""
    ti, acc, gyro = tsynth.imu_samples(0.06)
    sj = jpre.init_state()
    st = tpre.init_state(device="cpu")
    for k in range(len(ti)):
        sj = jpre.integrate(sj, jnp.asarray(ti[k], jnp.float32), jnp.asarray(acc[k], jnp.float32),
                            jnp.asarray(gyro[k], jnp.float32))
        st = tpre.integrate(st, torch.tensor(ti[k], dtype=torch.float32),
                            _t(acc[k].astype(np.float32)), _t(gyro[k].astype(np.float32)))
    for name in ("delta_p", "delta_v", "delta_q", "dt_sum", "last_t"):
        np.testing.assert_allclose(np.asarray(getattr(sj, name)), getattr(st, name).numpy(),
                                   atol=1e-5, err_msg=name)
    np.testing.assert_allclose(np.asarray(sj.P), st.P.numpy(), rtol=1e-4, atol=1e-12)
    assert float(st.dt_sum) > 0.05 and float(st.P[3, 3]) > 0


@pytest.fixture(scope="module")
def imu_run():
    """40 frames at 10 fps along the sweep with their IMU stream; one
    frame time repeated and one long gap, so invalid pairs occur."""
    ti, acc, gyro = tsynth.imu_samples(5.2)
    ts = np.arange(40) / 10.0
    ts[20] = ts[19]
    ts[30:] += 1.0   # 1.1 s gap: more than max_samples at 200 Hz
    ref = jvi.preintegrate_pairs(ti, acc, gyro, ts)
    got = tvi.preintegrate_pairs(ti, acc, gyro, ts, device="cpu")
    return ts, (ti, acc, gyro), ref, got


def test_preintegrate_pairs_matches(imu_run):
    _, _, ref, got = imu_run
    np.testing.assert_array_equal(ref[3], got[3])
    assert got[3].sum() == 37 and not got[3][19] and not got[3][29]
    for a, b, name in zip(ref[:3], got[:3], ("dp", "dv", "dts")):
        np.testing.assert_allclose(a, b, atol=1e-4, err_msg=name)


def test_align_matches(imu_run):
    """The alignment solve on the port's own preintegration against the
    reference's on its own: scale, gravity and velocities within 1e-4
    relative."""
    ts, _, ref, got = imu_run
    ts = ts[:19]
    pos, Rwb = tsynth.trajectory(ts)
    vo = 0.5 * pos  # an up-to-scale VO chain: the solve must find s = 2
    rj = jvi.align(vo, Rwb[:-1], *(x[:18] for x in ref), t_sel=ts - ts[0])
    rt = tvi.align(vo, Rwb[:-1], *(x[:18] for x in got), t_sel=ts - ts[0])
    assert rt["ok"] and rj["ok"] and abs(rt["s"] - 2.0) < 0.1
    for key in ("s", "residual", "excitation", "s_rel_std", "g_err"):
        np.testing.assert_allclose(rj[key], rt[key], rtol=1e-4, atol=1e-5, err_msg=key)
    np.testing.assert_allclose(rj["g"], rt["g"], atol=1e-3)
    np.testing.assert_allclose(rj["v"], rt["v"], atol=1e-3)


def test_scale_estimator_sequence_matches():
    """Five chunks of 16 frames at 10 fps of a half-scale chain through
    both estimators: the correction after every update within 1e-4, a
    rebase in between included; the window fills at 48 frames and the
    correction then moves toward 2."""
    n, fps = 81, 10.0
    ts = np.arange(n) / fps
    imu = tsynth.imu_samples(n / fps + 0.1)
    pos, R = tsynth.trajectory(ts)
    poses = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    poses[:, :3, :3] = R
    poses[:, :3, 3] = 0.5 * pos
    ej, et = jvi.ScaleEstimator(), tvi.ScaleEstimator(device="cpu")
    cj, ct = [], []
    scale = 1.0
    for s in range(0, n - 1, 16):
        sl = slice(s + (s > 0), s + 17)
        chunk = poses[sl].copy()
        chunk[:, :3, 3] *= scale
        cj.append(ej.update(ts[sl], chunk, *imu))
        ct.append(et.update(ts[sl], chunk, *imu))
        if s == 48:  # the pipeline rescales its state once the correction jumps
            scale = 1.5
            ej.rebase_scale(1.5)
            et.rebase_scale(1.5)
    np.testing.assert_allclose(cj, ct, rtol=1e-4)
    assert ct[1] == 1.0 and abs(ct[-1] - 2.0) < 0.3, ct
    assert et._n_good == ej._n_good >= 1


def test_stage_timer_keeps_first_event_apart():
    timer = StageTimer(device="cpu")
    for _ in range(3):
        with timer.stage("a"):
            pass
    with timer.stage("b"):
        pass
    s = timer.summary()
    assert s["a"]["count"] == 3 and s["b"]["count"] == 1
    assert s["b"]["mean_ms"] == s["b"]["warm_ms"]
    assert timer.warm_total_ms() == s["a"]["warm_ms"] + s["b"]["warm_ms"]
    assert "a:" in timer.report()


def test_fetch_many_keeps_dtypes_exactly():
    """One packed copy brings bools, int32 beyond 2^24 and float32 back
    bit-exact, in order and writable."""
    rng = np.random.default_rng(8)
    flags = rng.random(13) > 0.5
    ints = rng.integers(2**24, 2**30, (5, 3)).astype(np.int32)
    mats = rng.normal(size=(4, 4, 4)).astype(np.float32)
    outs = fetch_many([_t(flags), _t(ints), _t(mats)[:, ::2], torch.tensor(3.25)])
    assert [o.dtype for o in outs] == [np.bool_, np.int32, np.float32, np.float32]
    np.testing.assert_array_equal(outs[0], flags)
    np.testing.assert_array_equal(outs[1], ints)
    np.testing.assert_array_equal(outs[2], mats[:, ::2])
    assert float(outs[3]) == 3.25
    outs[2][0, 0, 0] = 0.0
