"""The port's two-view geometry and pose graph against the JAX package:
essential and homography RANSAC with JAX's own draws injected through
the sampler argument, the gyro-fused pose, the depth pins and scale
ratios, and the pose-graph optimiser."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from aria_slam_tpu import config as jcfg
from aria_slam_tpu.backend import pose_graph as jpg
from aria_slam_tpu.core import lie as jlie
from aria_slam_tpu.ops import epipolar as jep
from aria_slam_tpu.ops import homography as jhom
from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch.backend import pose_graph as tpg
from aria_slam_tpu_torch.core.types import PoseDelta
from aria_slam_tpu_torch.ops import epipolar as tep
from aria_slam_tpu_torch.ops import homography as thom
from aria_slam_tpu_torch.utils import profiling

from torch_parity_util import JaxKeySampler

K_NP = jcfg.CameraConfig().K  # EuRoC intrinsics


def _t(x):
    return torch.from_numpy(np.array(x))


def _correspondences(seed, n=384, planar=False, outliers=0.2, invalid=0.1, noise=0.1):
    """Two views of random points (or a plane at z = 4) with `noise` px
    noise, a share of gross outliers and of invalid slots. Returns xy1,
    xy2, valid and the true (R, t) with X2 = R X1 + t.

    The noise is kept well inside the 1 px gate: on ill-conditioned
    minimal samples the float32 8-point solve differs between XLA and
    torch by up to a few percent of E (different summation orders), so
    points within that margin of the gate flip between the two
    consensus sets (ROADMAP.md queue 3)."""
    rng = np.random.default_rng(seed)
    z = np.full(n, 4.0) if planar else rng.uniform(3.0, 9.0, n)
    X = np.stack([rng.uniform(-2.5, 2.5, n) * z / 4, rng.uniform(-1.5, 1.5, n) * z / 4, z], -1)
    R = np.asarray(jlie.so3_exp(jnp.asarray(rng.normal(0, 0.03, 3), jnp.float32)), np.float64)
    t = np.array([0.25, -0.04, 0.08]) + rng.normal(0, 0.02, 3)

    def project(P):
        uv = P[:, :2] / P[:, 2:3]
        return uv * [K_NP[0, 0], K_NP[1, 1]] + [K_NP[0, 2], K_NP[1, 2]]

    xy1 = project(X) + rng.normal(0, noise, (n, 2))
    xy2 = project(X @ R.T + t) + rng.normal(0, noise, (n, 2))
    bad = rng.random(n) < outliers
    xy2[bad] = np.stack([rng.uniform(0, 752, bad.sum()), rng.uniform(0, 480, bad.sum())], -1)
    valid = rng.random(n) >= invalid
    return xy1.astype(np.float32), xy2.astype(np.float32), valid, R.astype(np.float32), t


def _ransac_cfgs(**kw):
    kw = dict(num_hypotheses=128, **kw)
    return jcfg.RansacConfig(**kw), tcfg.RansacConfig(**kw)


def _assert_delta_close(ref, ours, mask_agree=0.995):
    np.testing.assert_allclose(np.asarray(ref.R), ours.R.numpy(), atol=1e-3)
    np.testing.assert_allclose(np.asarray(ref.t), ours.t.numpy(), atol=1e-3)
    assert (np.asarray(ref.inlier_mask) == ours.inlier_mask.numpy()).mean() >= mask_agree
    assert bool(ref.success) == bool(ours.success)


CASES = [("general", 0, False), ("general_2", 1, False), ("planar", 2, True)]


@pytest.mark.parametrize("name,seed,planar", CASES, ids=[c[0] for c in CASES])
def test_estimate_relative_pose_matches(name, seed, planar):
    xy1, xy2, valid, R_true, t_true = _correspondences(seed, planar=planar)
    jc, tc = _ransac_cfgs()
    key = jax.random.key(seed)
    ref = jep.estimate_relative_pose(jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid),
                                     jnp.asarray(K_NP), jc, key)
    ours = tep.estimate_relative_pose(_t(xy1), _t(xy2), _t(valid), _t(K_NP), tc,
                                      JaxKeySampler(key))
    _assert_delta_close(ref, ours)
    assert bool(ours.success)
    np.testing.assert_allclose(ours.R.numpy(), R_true, atol=5e-3)
    if not planar:  # a plane at one depth leaves the translation weakly observed
        assert float(ours.t.numpy() @ (t_true / np.linalg.norm(t_true))) > 0.98


def test_gyro_fused_pose_matches():
    xy1, xy2, valid, R_true, _ = _correspondences(3)
    jc, tc = _ransac_cfgs()
    key = jax.random.key(3)
    focal = 0.5 * (K_NP[0, 0] + K_NP[1, 1])
    thresh_sq = (jc.inlier_threshold_px / focal) ** 2
    R_g = R_true @ np.asarray(jlie.so3_exp(jnp.asarray([1e-3, -5e-4, 2e-4], jnp.float32)))
    for has_g in (True, False):
        ref = jep.estimate_pose_gyro_fused(
            jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid), jnp.asarray(K_NP), jc, key,
            jnp.asarray(R_g), jnp.asarray(has_g), thresh_sq)
        ours = tep.estimate_pose_gyro_fused(
            _t(xy1), _t(xy2), _t(valid), _t(K_NP), tc, JaxKeySampler(key),
            _t(R_g), torch.tensor(has_g), thresh_sq)
        _assert_delta_close(ref, ours)
        assert int(ref.num_inliers) == int(ours.num_inliers)


def test_sampson_polish_matches():
    """polish_pose_sampson from the same start and weights: the port's
    reverse-mode row Jacobians take the reference's jax.jacfwd steps."""
    xy1, xy2, valid, R_true, t_true = _correspondences(8, noise=0.5)
    K = jnp.asarray(K_NP)
    p1j, p2j = jep.normalize_points(jnp.asarray(xy1), K), jep.normalize_points(jnp.asarray(xy2), K)
    R0 = R_true @ np.asarray(jlie.so3_exp(jnp.asarray([4e-3, -3e-3, 2e-3], jnp.float32)))
    t0 = (t_true + [0.03, 0.02, -0.02]) / np.linalg.norm(t_true + [0.03, 0.02, -0.02])
    w = valid.astype(np.float32)
    thresh = (2.0 / K_NP[0, 0]) ** 2
    Rj, tj = jep.polish_pose_sampson(jnp.asarray(R0), jnp.asarray(t0, jnp.float32), p1j, p2j,
                                     jnp.asarray(w), thresh)
    Rt, tt = tep.polish_pose_sampson(_t(R0), _t(t0.astype(np.float32)), _t(p1j), _t(p2j),
                                     _t(w), thresh)
    np.testing.assert_allclose(np.asarray(Rj), Rt.numpy(), atol=1e-5)
    np.testing.assert_allclose(np.asarray(tj), tt.numpy(), atol=1e-5)
    assert np.abs(Rt.numpy() - R0).max() > 1e-3  # the polish moved the pose


def test_homography_ransac_and_motion_match():
    xy1, xy2, valid, _, _ = _correspondences(4, planar=True)
    p1j = jep.normalize_points(jnp.asarray(xy1), jnp.asarray(K_NP))
    p2j = jep.normalize_points(jnp.asarray(xy2), jnp.asarray(K_NP))
    p1t, p2t = _t(p1j), _t(p2j)
    thresh_sq = (1.0 / K_NP[0, 0]) ** 2
    key = jax.random.key(4)
    Hj, mj, sj = jhom.estimate_homography(p1j, p2j, jnp.asarray(valid),
                                          jax.random.fold_in(key, 77), 64, thresh_sq)
    Ht, mt, st = thom.estimate_homography(p1t, p2t, _t(valid), JaxKeySampler(key), 64,
                                          thresh_sq)
    Hj = np.asarray(Hj)
    np.testing.assert_allclose(Hj / np.linalg.norm(Hj), Ht.numpy() / Ht.norm().item(), atol=1e-4)
    assert (np.asarray(mj) == mt.numpy()).mean() >= 0.995 and abs(int(sj) - int(st)) <= 2
    for a, b in zip(jhom.decompose_homography(jnp.asarray(Hj)),
                    thom.decompose_homography(_t(Hj))):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4)
    R_hint = np.eye(3, dtype=np.float32)
    w = np.asarray(mj).astype(np.float32)
    for a, b in zip(jhom.best_h_motion(jnp.asarray(Hj), jnp.asarray(R_hint), p1j, p2j,
                                       jnp.asarray(w)),
                    thom.best_h_motion(_t(Hj), _t(R_hint), p1t, p2t, _t(w))):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4)


def test_depths_pins_and_ratios_match():
    """pair_depths, pin_depths (both estimators), pin_scale and
    geomean_ratio on one solved pair, within 1e-4 relative."""
    xy1, xy2, valid, _, _ = _correspondences(5)
    jc, _ = _ransac_cfgs()
    delta = jep.estimate_relative_pose(jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid),
                                       jnp.asarray(K_NP), jc, jax.random.key(5))
    tdelta = PoseDelta(**{f: _t(getattr(delta, f)) for f in
                          ("R", "t", "num_inliers", "inlier_mask", "success")})
    args_j = (jnp.asarray(xy1), jnp.asarray(xy2), jnp.asarray(valid), jnp.asarray(K_NP))
    args_t = (_t(xy1), _t(xy2), _t(valid), _t(K_NP))

    def close(a, b):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=1e-4, atol=1e-6)

    z1j, z2j, gj = jep.pair_depths(delta, *args_j)
    z1t, z2t, gt = tep.pair_depths(tdelta, *args_t)
    np.testing.assert_array_equal(np.asarray(gj), gt.numpy())
    g = gt.numpy()
    close(np.asarray(z1j)[g], z1t[gt])
    close(np.asarray(z2j)[g], z2t[gt])
    assert g.sum() > 100
    for est in ("triangulated", "tfree_parallax"):
        zj, mj = jep.pin_depths(delta, *args_j, est, 0.55)
        zt, mt = tep.pin_depths(tdelta, *args_t, est, 0.55)
        np.testing.assert_array_equal(np.asarray(mj), mt.numpy())
        close(np.asarray(zj)[np.asarray(mj)], zt[mt])
        for a, b in zip(jep.pin_scale(zj, mj, 4.0), tep.pin_scale(zt, mt, 4.0)):
            close(a, b)
    shared = gt & (torch.arange(len(g)) % 3 != 0)
    for a, b in zip(jep.geomean_ratio(z1j, z2j, jnp.asarray(shared.numpy())),
                    tep.geomean_ratio(z1t, z2t, shared)):
        close(a, b)


# ------------------------------------------------------------ pose graph
def _chain_graphs():
    """Both packages' 12-node chain with drift, one loop edge and
    gyro-weighted odometry -> (JAX graph, port graph, JAX config, port
    config)."""
    rng = np.random.default_rng(6)
    kw = dict(max_nodes=16, max_edges=24, lm_iterations=5, cg_iterations=24)
    jc, tc = jcfg.PoseGraphConfig(**kw), tcfg.PoseGraphConfig(**kw)
    gj, gt = jpg.init_graph(jc), tpg.init_graph(tc, "cpu")
    T = np.eye(4, dtype=np.float32)
    poses = [T]
    for i in range(1, 12):
        rel = np.asarray(jlie.se3_exp(jnp.asarray(
            np.r_[rng.normal(0, 0.2, 3), rng.normal(0, 0.05, 3)], jnp.float32)))
        T = T @ rel
        noisy = T @ np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.02, 6), jnp.float32)))
        poses.append(noisy.astype(np.float32))
        gj = jpg.add_odometry_edge(gj, i - 1, i, jnp.asarray(rel), jc,
                                   r_weight=2.0 if i % 2 else 1.0)
        gt = tpg.add_odometry_edge(gt, i - 1, i, _t(rel), tc, r_weight=2.0 if i % 2 else 1.0)
    for i, P in enumerate(poses):
        gj = jpg.set_node(gj, i, jnp.asarray(P))
        gt = tpg.set_node(gt, i, _t(P))
    loop = np.linalg.inv(poses[2]) @ poses[11]
    gj = jpg.add_loop_edge(gj, 2, 11, jnp.asarray(loop), jc, t_weight=0.5)
    gt = tpg.add_loop_edge(gt, 2, 11, _t(loop), tc, t_weight=0.5)
    return gj, gt, jc, tc


def test_pose_graph_optimize_matches():
    """A 12-node chain with drift, one loop edge and gyro-weighted
    odometry: the optimised poses agree within 1e-4."""
    gj, gt, jc, tc = _chain_graphs()
    for f in tpg.PoseGraph.__dataclass_fields__:
        np.testing.assert_allclose(np.asarray(getattr(gj, f)), getattr(gt, f).numpy(),
                                   atol=1e-6, err_msg=f)
    oj = jpg.optimize(gj, jc, 20)
    ot = tpg.optimize(gt, tc, 20)
    np.testing.assert_allclose(np.asarray(oj.node_pose), ot.node_pose.numpy(), atol=1e-4)
    assert torch.equal(tpg.get_pose(ot, 5), ot.node_pose[5])
    moved = np.abs(np.asarray(oj.node_pose) - np.asarray(gj.node_pose)).max()
    assert moved > 1e-3  # the optimiser did work


def test_pose_graph_in_place_step_matches_optimize():
    """The in-place LM step that optimize captures as CUDA graphs on a
    card, run op by op here on buffers first filled from an empty graph
    and then loaded with the chain, gives optimize's poses bit for bit;
    on the CPU a recorded optimize counts its iterations as eager and
    captures nothing."""
    _, gt, _, tc = _chain_graphs()
    n = 7
    step = tpg._static_step(tpg.init_graph(tc, "cpu"), tc)
    step.load(gt, tc.init_lambda)
    for _ in range(n):
        for part in step.parts:
            part()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        out = tpg.optimize(gt, tc, n)
    counters = profiling.recorded().counters
    assert torch.equal(step.graph.node_pose, out.node_pose)
    assert not torch.equal(out.node_pose, gt.node_pose)
    assert counters.get("pose_graph.eager_iters") == n
    assert "pose_graph.captures" not in counters
    assert "pose_graph.graphed_iters" not in counters


def test_edge_jacobians_match_jacfwd():
    """The port's reverse-mode row Jacobians equal the reference's
    jax.jacfwd blocks."""
    rng = np.random.default_rng(7)
    kw = dict(max_nodes=8, max_edges=8)
    jc, tc = jcfg.PoseGraphConfig(**kw), tcfg.PoseGraphConfig(**kw)
    gj, gt = jpg.init_graph(jc), tpg.init_graph(tc, "cpu")
    for i in range(6):
        P = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.5, 6), jnp.float32)))
        gj, gt = jpg.set_node(gj, i, jnp.asarray(P)), tpg.set_node(gt, i, _t(P))
    for i, j in ((0, 1), (1, 2), (2, 5), (4, 3)):
        rel = np.asarray(jlie.se3_exp(jnp.asarray(rng.normal(0, 0.3, 6), jnp.float32)))
        gj = jpg.add_odometry_edge(gj, i, j, jnp.asarray(rel), jc)
        gt = tpg.add_odometry_edge(gt, i, j, _t(rel), tc)
    for a, b in zip(jpg._edge_residuals_and_jacobians(gj),
                    tpg._edge_residuals_and_jacobians(gt.node_pose, gt)):
        np.testing.assert_allclose(np.asarray(a), b.numpy(), atol=1e-4)
