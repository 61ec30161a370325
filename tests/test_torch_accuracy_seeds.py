"""The port's accuracy regression on its own RANSAC draws: the rotloop of
tests/test_torch_accuracy.py (140 frames, 12 s period at 10 fps, chunk
16, the configuration of tests/test_accuracy.py) through the port's
euroc_eval.run on the CPU with the seeded torch generator the card's path
uses (epipolar.TorchSampler), seeds 0-3.

On this match-starved 320x240 scene the ATE moves with the draws by
about as much as the margin of the JAX test's 0.70 m gate, in both
packages (tools/accuracy_seeds.py, PERF.md): one seed alone may miss it.
So the ATE gate holds the median of the four seeds; each seed must find
the revisit, fuse no worse than its chain and keep its rotation drift
under the JAX test's bound."""

import numpy as np
import pytest
import torch

from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch.ops import epipolar

from test_torch_accuracy import CAM_KW, CHUNK, _cfg

SEEDS = (0, 1, 2, 3)


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The scene (the port's generator) and one loop-closing run a seed."""
    from aria_slam_tpu_torch.eval import euroc_eval
    from aria_slam_tpu_torch.io import synthetic_scene

    root = tmp_path_factory.mktemp("rotloop_seeds")
    scene = str(root / "scene")
    synthetic_scene.generate(scene, num_frames=140, fps=10.0, cam=tcfg.CameraConfig(**CAM_KW),
                             depth=4.0, traj="rotloop", period=12.0)
    out = {}
    for seed in SEEDS:
        sampler = epipolar.TorchSampler(torch.Generator().manual_seed(seed))
        out[seed] = euroc_eval.run(scene, out_dir=str(root / f"seed{seed}"), config=_cfg(tcfg),
                                   verbose=False, chunk=CHUNK, device="cpu", sampler=sampler)
        r = out[seed]
        print(f"\nseed {seed}: " + ", ".join(f"{n} {r[n]:.4f}" for n in (
            "ate_rmse_m", "ate_noscale_rmse_m", "ate_fused_rmse_m", "rpe_rot_deg",
            "umeyama_scale")) + f", loops {r['loops']}")
    return out


def test_median_ate_below_committed_threshold(results):
    """The JAX test's gate, Sim3 ATE < 0.70 m, on the median of the seeds
    (measured 0.665 m: 0.768 / 0.486 / 0.705 / 0.624 m; the JAX package's
    own seeds 0-3 read 0.533-0.700 m, median 0.633 m)."""
    ates = [results[s]["ate_rmse_m"] for s in SEEDS]
    assert np.isfinite(ates).all() and np.median(ates) < 0.70, ates


@pytest.mark.parametrize("seed", SEEDS)
def test_each_seed_closes_the_loop_and_fuses(results, seed):
    """The revisit is found, the fused track is at least as good as the
    chain (Sim3 and raw), and rotation RPE stays under 1 degree."""
    r = results[seed]
    assert r["loops"] >= 1
    assert r["ate_fused_rmse_m"] <= r["ate_rmse_m"] + 1e-3
    assert r["ate_fused_raw_rmse_m"] <= r["ate_raw_rmse_m"] + 1e-3
    assert r["rpe_rot_deg"] < 1.0
