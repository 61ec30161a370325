"""The pose graph's CUDA graphs on a card (backend/pose_graph.optimize):
the replayed LM iterations match the same step run op by op on the card,
a later call with other edges and poses reuses the capture, a result is
not overwritten by the next call, another capacity captures anew, and a
capture under a CUDA profiler works. Every test here needs a card and
skips without one:

    python -m pytest --noconftest -m card tests/test_torch_pose_graph_card.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from aria_slam_tpu_torch.backend import pose_graph as tpg
from aria_slam_tpu_torch.config import PoseGraphConfig
from aria_slam_tpu_torch.core import lie
from aria_slam_tpu_torch.utils import profiling

# capacities no other caller in the process uses, so the first call captures
CFG = PoseGraphConfig(max_nodes=13, max_edges=17, lm_iterations=5, cg_iterations=24)


def _chain(cfg, seed, n=11):
    """A drifting n-node chain with gyro-weighted odometry and one loop
    edge, on the card."""
    rng = np.random.default_rng(seed)
    dev = torch.device("cuda")

    def exp(scale_t, scale_r):
        xi = np.r_[rng.normal(0, scale_t, 3), rng.normal(0, scale_r, 3)]
        return lie.se3_exp(torch.tensor(xi, dtype=torch.float32, device=dev))

    g = tpg.init_graph(cfg, dev)
    T = torch.eye(4, device=dev)
    poses = [T]
    for i in range(1, n):
        rel = exp(0.2, 0.05)
        T = T @ rel
        poses.append(T @ exp(0.02, 0.02))
        g = tpg.add_odometry_edge(g, i - 1, i, rel, cfg, r_weight=2.0 if i % 2 else 1.0)
    for i, P in enumerate(poses):
        g = tpg.set_node(g, i, P)
    return tpg.add_loop_edge(g, 2, n - 1, torch.linalg.inv(poses[2]) @ poses[-1], cfg,
                             t_weight=0.5)


def _op_by_op(g, cfg, iters):
    step = tpg._static_step(g, cfg)
    for _ in range(iters):
        for part in step.parts:
            part()
    return step.graph.node_pose


def _counted(fn, activities=(torch.profiler.ProfilerActivity.CPU,)):
    with torch.profiler.profile(activities=list(activities)):
        out = fn()
        torch.cuda.synchronize()
    return out, profiling.recorded().counters


@pytest.mark.card
def test_replayed_iterations_match_op_by_op_and_reuse_the_capture():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    g1, g2 = _chain(CFG, 1), _chain(CFG, 2, n=9)
    o1, c1 = _counted(lambda: tpg.optimize(g1, CFG, 20))
    assert c1.get("pose_graph.captures") == 1
    assert c1.get("pose_graph.graphed_iters") == 20
    assert c1.get("pose_graph.eager_iters") == tpg.WARMUP_ITERATIONS
    assert (o1.node_pose - g1.node_pose).abs().max() > 1e-3  # the optimiser did work
    torch.testing.assert_close(o1.node_pose, _op_by_op(g1, CFG, 20), atol=1e-5, rtol=0)
    kept = o1.node_pose.clone()

    o2, c2 = _counted(lambda: tpg.optimize(g2, CFG, 7))
    assert "pose_graph.captures" not in c2 and "pose_graph.eager_iters" not in c2
    assert c2.get("pose_graph.graphed_iters") == 7
    torch.testing.assert_close(o2.node_pose, _op_by_op(g2, CFG, 7), atol=1e-5, rtol=0)
    assert torch.equal(o1.node_pose, kept)  # the second call left the first's result alone


@pytest.mark.card
def test_another_capacity_captures_anew_also_under_a_cuda_profiler():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; this machine has none")
    cfg = dataclasses.replace(CFG, max_nodes=19, max_edges=23)
    g = _chain(cfg, 3, n=15)
    acts = (torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA)
    out, counters = _counted(lambda: tpg.optimize(g, cfg, 5), acts)
    assert counters.get("pose_graph.captures") == 1
    assert counters.get("pose_graph.graphed_iters") == 5
    torch.testing.assert_close(out.node_pose, _op_by_op(g, cfg, 5), atol=1e-5, rtol=0)
