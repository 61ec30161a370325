"""The online navigation cell on the CPU at a small size: it is correct;
its pose-graph reference agrees with the program's `pose_graph.optimize`
on seeded random graphs and its NMS reference with `ops/boxes.nms` on
seeded boxes; each planted fault fails its number (the loop edge added
at weight 1 fails `pg_gap`, NMS with its IoU comparison flipped
`nms_rows`). Half the CG steps fails `pg_gap` only at the cell's own
size (PERF.md §4): on the small circuit's graph it moves the nodes by
less than the limit, so the reference alone shows it here, on a random
graph."""

import dataclasses

import numpy as np
import pytest
import torch

from slam_bench.harness import core
from slam_bench.reference import nms as ref_nms, pose_graph as ref_pg
from slam_bench.tests import small_online


def _limit(name):
    return core.find_cell(small_online.CELL).limits[name]["max"]


def test_online_cell_is_correct():
    checks, numbers = small_online.run_frames()
    assert all(ok for *_, ok in checks), checks
    assert numbers["sampled_frames"] >= 1 and numbers["sampled_loops"] >= 1, numbers
    assert numbers["loops_min"] >= 1


def test_online_cell_runs_through_the_harness():
    # a short window on a busy machine may hold no sampled frame or loop:
    # the correctness of a fixed set of frames is the test above
    result, _, _ = small_online.run(seconds=4.0)
    assert result["attempted"] >= 1 and set(result["metrics"]) == {"frames_per_s", "setup_s"}
    assert set(result["checks"]) == set(core.find_cell(small_online.CELL).limits)


# ------------------------------------------------------------ pose graph
def _graph(seed, n=60):
    """A noisy odometry chain around a circle with gyro-weighted rotations
    and one loop edge back to node 1, at capacities above its size."""
    from aria_slam_tpu_torch.backend import pose_graph as pg
    from aria_slam_tpu_torch.config import PoseGraphConfig
    from aria_slam_tpu_torch.core import lie

    rng = np.random.default_rng(seed)
    cfg = PoseGraphConfig(max_nodes=96, max_edges=160, lm_iterations=5, cg_iterations=24)
    g = pg.init_graph(cfg, "cpu")
    g = pg.set_node(g, 0, torch.eye(4))
    truth = [lie.se3_exp(torch.tensor([2 * np.cos(a), 2 * np.sin(a), 0.1 * np.sin(3 * a), 0, 0,
                                       a], dtype=torch.float32))
             for a in 2 * np.pi * np.arange(n) / n]
    pose = truth[0]
    for k in range(1, n):
        noise = torch.tensor(rng.normal(0, [0.01] * 3 + [0.003] * 3), dtype=torch.float32)
        rel = lie.se3_inverse(truth[k - 1]) @ truth[k] @ lie.se3_exp(noise)
        pose = pose @ rel
        g = pg.set_node(g, k, pose)
        g = pg.add_odometry_edge(g, k - 1, k, rel, cfg, r_weight=25.0 if k % 3 else 1.0)
    g = pg.add_loop_edge(g, 1, n - 1, lie.se3_inverse(truth[1]) @ truth[n - 1], cfg,
                         t_weight=float(rng.uniform(0.3, 1.0)))
    return g, cfg


def _reference(g, cfg, cg_iterations=None):
    nn, ne = int(g.num_nodes), int(g.num_edges)
    return ref_pg.optimize(g.node_pose[:nn], g.node_valid[:nn], g.edge_i[:ne], g.edge_j[:ne],
                           g.edge_rel[:ne], g.edge_weight[:ne] * g.edge_valid[:ne].float(),
                           g.edge_twt[:ne], g.edge_rwt[:ne], cfg.lm_iterations,
                           cg_iterations or cfg.cg_iterations, cfg.init_lambda)


@pytest.mark.parametrize("seed", (0, 1, 2))
def test_pose_graph_reference_matches_the_program(seed):
    from aria_slam_tpu_torch.backend import pose_graph as pg

    g, cfg = _graph(seed)
    nn = int(g.num_nodes)
    prog = pg.optimize(g, cfg).node_pose[:nn]
    ref = _reference(g, cfg)
    moved = (prog[:, :3, 3] - g.node_pose[:nn, :3, 3]).norm(dim=-1).max()
    gap = (prog[:, :3, 3] - ref[:, :3, 3]).norm(dim=-1).max()
    assert moved > 0.1  # the loop pulls the chain
    assert gap < _limit("pg_gap") / 100, gap
    # half the CG steps is a different answer on this graph
    half = _reference(g, cfg, cfg.cg_iterations // 2)
    assert (half[:, :3, 3] - ref[:, :3, 3]).norm(dim=-1).max() > _limit("pg_gap")


# ----------------------------------------------------------------- NMS
@pytest.mark.parametrize("seed", (3, 4, 5, 6))
def test_nms_reference_matches_the_program(seed):
    from aria_slam_tpu_torch.ops import boxes

    b, s, v = map(torch.from_numpy, ref_nms.draw(np.random.default_rng(seed), 300, 640))
    keep = boxes.nms(b, s, v, 0.45)
    want = ref_nms.greedy(b, s, v, 0.45)
    assert torch.equal(keep, want)
    assert 0 < int(want.sum()) < int(v.sum())  # the boxes overlap: NMS has work


# -------------------------------------------------------- planted faults
def flipped_nms(boxes, scores, valid, iou_threshold=0.45, max_out=None):
    """ops/boxes.nms with its IoU comparison flipped (< for >=)."""
    from aria_slam_tpu_torch.ops.boxes import iou_matrix

    d = boxes.shape[-2]
    ar = torch.arange(d, device=boxes.device)
    suppress = (iou_matrix(boxes) < iou_threshold) | (ar[:, None] == ar[None, :])
    alive = valid & (scores > 0)
    keep = torch.zeros_like(alive)
    for _ in range(max_out or d):
        best = torch.where(alive, scores, -1e30).argmax(-1, keepdim=True)
        keep |= (ar == best) & alive
        alive &= ~torch.take_along_dim(suppress, best[..., None], -2)[..., 0, :]
    return keep


def _fault(name, monkeypatch):
    from aria_slam_tpu_torch.backend import pose_graph as pg
    from aria_slam_tpu_torch.ops import boxes

    if name == "loop_weight_1":
        orig = pg.add_loop_edge

        def add_loop_edge(g, i, j, rel, cfg, t_weight=1.0):
            return orig(g, i, j, rel, dataclasses.replace(cfg, loop_edge_weight=1.0), t_weight)
        monkeypatch.setattr(pg, "add_loop_edge", add_loop_edge)
    else:
        monkeypatch.setattr(boxes, "nms", flipped_nms)


@pytest.mark.parametrize("fault,number", [("loop_weight_1", "pg_gap"),
                                          ("flipped_iou", "nms_rows")])
def test_planted_fault_fails_its_number(fault, number, monkeypatch):
    _fault(fault, monkeypatch)
    checks, _ = small_online.run_frames()
    got = {n: (v, ok) for n, v, _, ok in checks}
    assert not got[number][1], checks
