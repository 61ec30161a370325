"""The port's accuracy regression: tests/test_accuracy.py's 140-frame
rotloop (12 s period at 10 fps, so the last ~20 frames re-see the start)
through the port's euroc_eval.run in chunk mode on the CPU, with and
without loop closure, held to the JAX test's six gates, and its ATE
held to the JAX package's own run of the loop-closing variant on the
same files.

The port draws the JAX run's RANSAC samples (the JAX evaluator's
default key chain), as the other parity tests do: on this match-starved
320x240 scene the ATE moves with the draws in both packages, by as much
as the margin of the JAX test's 0.70 m gate (its seed-0 run plus 25 %),
which some seeds of either package miss (PERF.md, Findings). The port on
its own generator is held over four seeds in
tests/test_torch_accuracy_seeds.py."""

import dataclasses

import jax
import numpy as np
import pytest

from aria_slam_tpu import config as jcfg
from aria_slam_tpu_torch import config as tcfg

from torch_parity_util import JaxChunkChainSampler

CHUNK = 16
LAG = 4  # the evaluator's lag at this chunk: min(mapper.pair_lag, chunk)

CAM_KW = dict(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
              k1=0.0, k2=0.0, p1=0.0, p2=0.0)


def _cfg(module):
    """tests/test_accuracy.py's configuration, from either package."""
    return module.PipelineConfig(
        camera=module.CameraConfig(**CAM_KW),
        orb=module.OrbConfig(num_features=384, num_levels=3),
        ransac=module.RansacConfig(num_hypotheses=128),
        loop=module.LoopClosureConfig(max_keyframes=192, min_frames_between=90,
                                      min_score=0.3, min_matches=40),
        mapper=module.MapperConfig(max_points=60000, pair_lag=4),
        pose_graph=module.PoseGraphConfig(max_nodes=192, max_edges=512,
                                          lm_iterations=5, cg_iterations=32),
        vo_scale_mode="median_depth",
    )


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    """The scene (the port's generator), the port's lc and nolc runs and
    the JAX package's lc run, all at chunk 16, the port on the JAX run's
    draws."""
    from aria_slam_tpu.eval import euroc_eval as jeval
    from aria_slam_tpu_torch.eval import euroc_eval as teval
    from aria_slam_tpu_torch.io import synthetic_scene

    root = tmp_path_factory.mktemp("rotloop")
    scene = str(root / "scene")
    synthetic_scene.generate(scene, num_frames=140, fps=10.0, cam=tcfg.CameraConfig(**CAM_KW),
                             depth=4.0, traj="rotloop", period=12.0)
    cfg = _cfg(tcfg)
    out = {
        "lc": teval.run(scene, out_dir=str(root / "lc"), config=cfg, verbose=False,
                        chunk=CHUNK, device="cpu",
                        sampler=JaxChunkChainSampler(jax.random.key(0), LAG)),
        "nolc": teval.run(scene, out_dir=str(root / "nolc"),
                          config=dataclasses.replace(cfg, enable_loop_closure=False),
                          verbose=False, chunk=CHUNK, device="cpu",
                          sampler=JaxChunkChainSampler(jax.random.key(0), LAG)),
        "jax_lc": jeval.run(scene, out_dir=str(root / "jax_lc"), config=_cfg(jcfg),
                            verbose=False, chunk=CHUNK),
    }
    for k, r in out.items():
        print(f"\n{k}: " + ", ".join(f"{n} {r[n]:.4f}" for n in (
            "ate_rmse_m", "ate_noscale_rmse_m", "ate_fused_rmse_m", "rpe_rot_deg",
            "umeyama_scale") if n in r) + f", loops {r['loops']}")
    return out


def test_ate_below_committed_threshold(results):
    """The JAX test's gate: Sim3 ATE < 0.70 m on this scene."""
    ate = results["lc"]["ate_rmse_m"]
    assert np.isfinite(ate) and ate < 0.70, f"ATE {ate:.3f} m"


def test_ate_near_the_jax_run(results):
    """The port's ATE within 0.15 m of the JAX package's on the same files
    and draws. Measured 0.5113 against 0.5904 m, 0.079 m apart: float32
    rounding picks between the two consensus sets of weakly observed
    pairs (ROADMAP.md queue 3), so the port on the JAX draws lands as on
    a nearby draw. The bound sits under the spread of the JAX package's
    own seeds 0-3 on this scene, 0.533-0.700 m (0.167 m wide;
    tools/accuracy_seeds.py); the port's own seeds are held in
    tests/test_torch_accuracy_seeds.py."""
    t, j = results["lc"]["ate_rmse_m"], results["jax_lc"]["ate_rmse_m"]
    assert abs(t - j) < 0.15, (t, j)


def test_loop_closure_found_and_not_harmful(results):
    """The revisit is detected, and loop edges do not degrade the ATE."""
    assert results["lc"]["loops"] >= 1
    assert results["lc"]["ate_rmse_m"] <= results["nolc"]["ate_rmse_m"] * 1.15 + 0.02


def test_fused_beats_optimized_chain(results):
    """The offline fused track (RTS smoother over the loop-closed,
    final-optimised chain) is at least as good as the chain, Sim3 and raw."""
    r = results["lc"]
    assert r["ate_fused_rmse_m"] <= r["ate_rmse_m"] + 1e-3
    assert r["ate_fused_raw_rmse_m"] <= r["ate_raw_rmse_m"] + 1e-3


def test_rotation_rpe_bounded(results):
    assert results["lc"]["rpe_rot_deg"] < 1.0


def test_lc_does_not_twist_rotations(results):
    assert results["lc"]["rpe_rot_deg"] <= results["nolc"]["rpe_rot_deg"] * 1.5 + 0.02


def test_loop_closure_preserves_metric_scale(results):
    s_lc, s_nolc = results["lc"]["umeyama_scale"], results["nolc"]["umeyama_scale"]
    assert abs(np.log(s_lc / s_nolc)) < 0.05
    assert results["lc"]["ate_noscale_rmse_m"] <= results["nolc"]["ate_noscale_rmse_m"] * 1.05 + 0.01
