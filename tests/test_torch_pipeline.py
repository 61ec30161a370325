"""The slice end to end: the port's online VO-only SlamPipeline (on the
CPU, through the kernels' plain versions) against the JAX package's on
the same rendered frames and IMU, with the JAX pipeline's own RANSAC key
chain injected through the sampler; and one frame step started from the
exact carry a JAX step produced (convert.py)."""

import dataclasses

import numpy as np
import pytest
import torch

import jax

from aria_slam_tpu.eval import metrics as jmetrics
from aria_slam_tpu.io import euroc, synthetic_scene
from aria_slam_tpu.pipeline.slam_pipeline import SlamPipeline as JaxPipeline
from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch import convert
from aria_slam_tpu_torch.eval import metrics as tmetrics
from aria_slam_tpu_torch.pipeline import factory
from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline

from torch_parity_util import JAX_SMALL_CFG, JaxChainSampler, to_np

NUM_FRAMES = 12
ONE_STEP_FRAME = 6  # the JAX carry after this frame seeds the port's next step


def _feed(pipe, data, k, t_prev):
    """One frame as euroc_eval feeds it: IMU samples in (t_prev, ts]."""
    ts = data.image_ts[k]
    imu_t, imu_a, imu_g = euroc.imu_window(data, t_prev, ts)
    for j in range(len(imu_t)):
        pipe.process_imu(imu_t[j], imu_a[j], imu_g[j])
    pipe.process_frame(euroc.load_image_safe(data.image_paths[k]), ts)
    o = pipe.last_output
    return (int(o.num_features), int(o.num_inliers), bool(o.vo_success)), ts


def _rot_deg(Ra, Rb):
    c = np.clip((np.trace(Ra.T @ Rb) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("scene"))
    synthetic_scene.generate(out, num_frames=NUM_FRAMES, fps=5.0,
                             cam=JAX_SMALL_CFG.camera, depth=4.0)
    data = euroc.load(out)
    jcfg = dataclasses.replace(JAX_SMALL_CFG, camera=data.camera,
                               imu_cam_rotation=tuple(map(tuple, data.R_cam_imu.tolist())))
    tcfg_ = tcfg.PipelineConfig.from_dict(jcfg.to_dict())

    jpipe = JaxPipeline(jcfg, seed=0)
    tpipe = factory.create_cpu(tcfg_, sampler=JaxChainSampler(jax.random.key(0)))
    res = {"data": data, "cfg": tcfg_, "jax": [], "torch": []}
    t_prev = -np.inf
    for k in range(NUM_FRAMES):
        if k == ONE_STEP_FRAME + 1:
            res["carry"] = to_np(jpipe.state)
            res["key"] = jax.random.key_data(jpipe.state.key)
            res["t0"], res["t_prev"] = jpipe._t0, t_prev
        res["jax"].append(_feed(jpipe, data, k, t_prev)[0])
        res["torch"].append(_feed(tpipe, data, k, t_prev)[0])
        t_prev = data.image_ts[k]
    res["online"] = ([T for _, T in jpipe.trajectory], [T for _, T in tpipe.trajectory])
    jpipe.finalize()
    tpipe.finalize()
    res["final"] = (np.stack([T for _, T in jpipe.trajectory]),
                    np.stack([T for _, T in tpipe.trajectory]))
    gt = [synthetic_scene.trajectory(ts - data.image_ts[0]) for ts in data.image_ts]
    res["gt"] = (np.stack([p for p, _ in gt]), np.stack([R for _, R in gt]))
    return res


def test_slice_matches_jax_pipeline(runs):
    (jT, tT), (gt_pos, gt_R) = runs["final"], runs["gt"]
    ate_j = jmetrics.ate_rmse(jT[:, :3, 3], gt_pos)
    ate_t = tmetrics.ate_rmse(tT[:, :3, 3], gt_pos)
    rpe_j = jmetrics.rpe_rot_rmse_deg(jT[:, :3, :3], gt_R, delta=5)
    rpe_t = tmetrics.rpe_rot_rmse_deg(tT[:, :3, :3], gt_R, delta=5)
    # tests/test_pipeline.py's gates, for both packages
    for ate, rpe in ((ate_j, rpe_j), (ate_t, rpe_t)):
        assert np.isfinite(ate) and ate < 0.35, (ate_j, ate_t)
        assert np.isfinite(rpe) and rpe < 25.0, (rpe_j, rpe_t)
    assert abs(ate_t - ate_j) <= 0.02, (ate_j, ate_t)
    for a, b in zip(*runs["online"]):
        assert _rot_deg(a[:3, :3], b[:3, :3]) <= 0.5
    for (fj, _, okj), (ft, _, okt) in zip(runs["jax"], runs["torch"]):
        assert abs(fj - ft) <= 0.01 * fj
    assert [ok for *_, ok in runs["torch"]][1:] == [True] * (NUM_FRAMES - 1)
    assert [ok for *_, ok in runs["jax"]] == [ok for *_, ok in runs["torch"]]


def test_metrics_match_reference(runs):
    (_, tT), (gt_pos, gt_R) = runs["final"], runs["gt"]
    est = tT[:, :3, 3] * 1.7 + 0.3
    for a, b in zip(jmetrics.align_umeyama(est, gt_pos), tmetrics.align_umeyama(est, gt_pos)):
        np.testing.assert_allclose(a, b, atol=1e-9)
    assert jmetrics.ate_rmse(est, gt_pos, align=False) == tmetrics.ate_rmse(est, gt_pos,
                                                                            align=False)


def test_one_step_from_jax_carry(runs):
    """The port's step started from the JAX carry after frame k (through
    convert.py) gives the JAX pipeline's frame k+1."""
    data, k = runs["data"], ONE_STEP_FRAME + 1
    pipe = SlamPipeline(runs["cfg"], device="cpu",
                        sampler=JaxChainSampler(jax.random.wrap_key_data(runs["key"])))
    pipe.state = convert.frame_state_from_numpy(runs["carry"], "cpu")
    pipe._t0 = runs["t0"]
    assert pipe.state.frame_id == k
    (nf, ninl, ok), _ = _feed(pipe, data, k, runs["t_prev"])
    jnf, jninl, jok = runs["jax"][k]
    assert (nf, ok) == (jnf, jok)
    assert abs(ninl - jninl) <= max(2, 0.02 * jninl)
    jpose = runs["online"][0][k]
    pose = pipe.trajectory[-1][1]
    assert _rot_deg(jpose[:3, :3], pose[:3, :3]) <= 0.05
    step_j = jpose[:3, 3] - runs["online"][0][k - 1][:3, 3]
    step_t = pose[:3, 3] - runs["online"][0][k - 1][:3, 3]
    assert np.linalg.norm(step_t - step_j) <= 0.02 * np.linalg.norm(step_j)


def test_convert_carries_every_field(runs):
    s = convert.frame_state_from_numpy(runs["carry"], "cpu")
    c = runs["carry"]
    np.testing.assert_array_equal(s.prev_feats.desc.numpy(), c.prev_feats.desc)
    np.testing.assert_array_equal(s.graph.edge_rel.numpy(), c.graph.edge_rel)
    assert s.prev_feats.desc.dtype == torch.int8 and s.graph.edge_i.dtype == torch.int32
    assert s.prev_valid.dtype == torch.bool and s.pose.dtype == torch.float32


def test_mock_pipeline_runs():
    from torch_parity_util import TORCH_SMALL_CFG

    pipe = factory.create_mock(TORCH_SMALL_CFG, device="cpu")
    rng = np.random.default_rng(0)
    for k in range(4):
        pose = pipe.process_frame(rng.uniform(0, 255, (240, 320)).astype(np.float32), k * 0.1)
        assert pose.shape == (4, 4) and np.isfinite(pose).all()
    assert len(pipe.trajectory) == 4
    assert factory.ExecutionMode("cpu") is factory.ExecutionMode.CPU
