"""The main path's benchmark scripts on the CPU, against the JAX package:
accuracy_benchmark's configuration and flags, euroc_eval.run in its
default online mode with every feature on (both packages on one scene,
the port drawing the JAX run's samples), longrun's loop scoring and miss
attribution, the generator's occluder, and online_benchmark's two
modes."""

import dataclasses
import functools
import os

import cv2
import numpy as np
import pytest

import jax

from aria_slam_tpu import config as jcfg
from aria_slam_tpu.eval import accuracy_benchmark as jbench
from aria_slam_tpu.eval import euroc_eval as jeval
from aria_slam_tpu.eval import longrun as jlongrun
from aria_slam_tpu.io import euroc as jeuroc
from aria_slam_tpu.io import synthetic_scene as jsynth
from aria_slam_tpu.pipeline import slam_pipeline as jslam
from aria_slam_tpu_torch import config as tcfg
from aria_slam_tpu_torch.eval import accuracy_benchmark as tbench
from aria_slam_tpu_torch.eval import euroc_eval as teval
from aria_slam_tpu_torch.eval import longrun as tlongrun
from aria_slam_tpu_torch.eval import online_benchmark
from aria_slam_tpu_torch.io import euroc as teuroc
from aria_slam_tpu_torch.io import synthetic_scene as tsynth

from torch_parity_util import ONLINE_SCENE, ONLINE_SEED, JaxChainSampler, online_config


@pytest.mark.parametrize("full_res", [False, True])
def test_benchmark_config_equals_jax(full_res):
    for frames in (240, 1040):
        assert (tbench.benchmark_config(full_res, frames).to_dict()
                == jbench.benchmark_config(full_res, frames).to_dict())
    assert tbench.SMALL_CAM == tcfg.CameraConfig(**dataclasses.asdict(jbench.SMALL_CAM))


def test_excited_needs_chunked_mode(capsys):
    with pytest.raises(SystemExit) as e:
        tbench.main(["--excited", "--chunk", "0"])
    assert e.value.code == 2 and "--excited requires chunked mode" in capsys.readouterr().err


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("scene"))
    jsynth.generate(out, cam=online_config(jcfg).camera, **ONLINE_SCENE)
    return out


@pytest.fixture(scope="module")
def online_runs(scene, tmp_path_factory):
    """euroc_eval.run with chunk=0 and every feature on, both packages on
    the same scene; the JAX run's pipeline seeded with ONLINE_SEED (its
    euroc_eval takes no seed), the port drawing from that key chain."""
    d = tmp_path_factory.mktemp("online")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jslam, "SlamPipeline",
                   functools.partial(jslam.SlamPipeline, seed=ONLINE_SEED))
        jres = jeval.run(scene, out_dir=str(d / "jax"), config=online_config(jcfg),
                         verbose=False, chunk=0, keep_pipe=True)
    tres = teval.run(scene, out_dir=str(d / "port"), config=online_config(tcfg), verbose=False,
                     chunk=0, keep_pipe=True, device="cpu",
                     sampler=JaxChainSampler(jax.random.key(ONLINE_SEED)))
    return jres, tres, d


def test_online_euroc_eval_matches_jax(online_runs):
    """The default online mode end to end: every ATE flavour, the fused
    three included, within 0.05 m of the JAX run's; the same loops; the
    map's count within 10 %."""
    jres, tres, _ = online_runs
    assert tres["frames"] == jres["frames"] == ONLINE_SCENE["num_frames"]
    assert tres["loops"] == jres["loops"] >= 1
    assert abs(tres["map_points"] - jres["map_points"]) <= 0.1 * jres["map_points"]
    for k in ("ate_rmse_m", "ate_noscale_rmse_m", "ate_raw_rmse_m", "ate_fused_rmse_m",
              "ate_fused_noscale_rmse_m", "ate_fused_raw_rmse_m"):
        print(f"{k}: port {tres[k]:.4f} m, JAX {jres[k]:.4f} m")
        assert np.isfinite(tres[k]) and abs(tres[k] - jres[k]) < 0.05, (k, tres[k], jres[k])
    assert {"decode", "imu", "frame_step"} <= set(tres["stage_ms"])


def test_online_euroc_eval_writes_its_files(online_runs):
    """estimated_trajectory.txt and fused_trajectory.txt (the online EKF's
    track) hold one line a frame as the JAX run's; map.ply and map.pcd
    hold map_points points."""
    jres, tres, d = online_runs
    for name in ("estimated_trajectory.txt", "fused_trajectory.txt"):
        t, j = np.loadtxt(d / "port" / name), np.loadtxt(d / "jax" / name)
        assert t.shape == j.shape == (tres["frames"], 4), name
        np.testing.assert_array_equal(t[:, 0], j[:, 0])
    ply = (d / "port" / "map.ply").read_text().splitlines()
    assert tres["map_points"] > 50 and f"element vertex {tres['map_points']}" in ply
    assert len(ply) == ply.index("end_header") + 1 + tres["map_points"]
    assert f"POINTS {tres['map_points']}" in (d / "port" / "map.pcd").read_text()


def test_longrun_scoring_matches_jax(scene):
    """loop_truth and diag_attribution on the same scene, loop pairs and
    loop-closure diagnostics (random, in ChunkedSlam.lc_diag's layout,
    with the chunked evaluator's padded pair ids and overwritten -2
    candidates) as the JAX functions give them, exactly."""
    frames, min_gap, cap, min_score = ONLINE_SCENE["num_frames"], 8, 16, 0.3
    jdata, tdata = jeuroc.load(scene), teuroc.load(scene)
    rng = np.random.default_rng(4)
    pairs = [(int(rng.integers(0, 12)), int(j)) for j in rng.integers(10, frames + 3, 12)]
    for gt_dist in (0.2, 0.5):
        assert (tlongrun.loop_truth(tdata, frames, pairs, min_gap, gt_dist, cap)
                == jlongrun.loop_truth(jdata, frames, pairs, min_gap, gt_dist, cap))
    diag, c, nk = [], 6, 8
    for base in range(0, frames, c):
        if base == 6:  # a chunk without a query
            diag.append({"base": base, "c": c, "cand_fid": None, "scores": None, "sel": [],
                         "fidx": None, "passed": None})
            continue
        cand = rng.integers(-2, frames, (c, nk))
        scores = np.round(rng.random((c, nk)), 2).astype(np.float32)
        sel = sorted(rng.choice(c * nk, 10, replace=False).tolist())
        verified = base != 12
        diag.append({"base": base, "c": c, "cand_fid": cand, "scores": scores, "sel": sel,
                     "fidx": None, "passed": rng.random(10) > 0.5 if verified else None,
                     "n_inliers": rng.integers(0, 200, 10) if verified else None})
    for gt_dist in (0.3, 1.0):
        want = jlongrun.diag_attribution(jdata, frames, min_gap, gt_dist, cap, min_score, diag)
        got = tlongrun.diag_attribution(tdata, frames, min_gap, gt_dist, cap, min_score, diag)
        assert got == want
        assert sum(want[k] for k in ("recalled", "verify", "budget", "score", "prefilter",
                                     "no_query")) > 0


def test_generate_occluder_matches_jax(tmp_path):
    """generate(occluder=True) against the JAX generator: the frames within
    the renderer tolerance of tests/test_torch_eval.py (99 % of pixels
    within one grey level, mean difference < 0.3), the occluding block's
    grey level, from the reference's own draws, equal."""
    kw = dict(num_frames=8, fps=10.0, depth=4.0, occluder=True, period=4.0)
    cam = online_config(jcfg).camera
    jsynth.generate(str(tmp_path / "jax"), cam=cam, **kw)
    tsynth.generate(str(tmp_path / "port"), cam=tcfg.CameraConfig(**dataclasses.asdict(cam)),
                    **kw)
    names = sorted(os.listdir(tmp_path / "jax" / "mav0" / "cam0" / "data"))
    assert names == sorted(os.listdir(tmp_path / "port" / "mav0" / "cam0" / "data"))
    for k, name in enumerate(names):
        ours, ref = (cv2.imread(str(tmp_path / w / "mav0" / "cam0" / "data" / name),
                                cv2.IMREAD_GRAYSCALE) for w in ("port", "jax"))
        diff = np.abs(ours.astype(int) - ref.astype(int))
        assert (diff <= 1).mean() >= 0.99 and diff.mean() < 0.3, (name, diff.mean())
        # the block's left edge and centre row (x1 = 0 until it has entered)
        x2 = int((k * 7) % (cam.width + cam.width // 4))
        cy = cam.height // 2 + int(20 * np.sin(k / 9.0))
        if x2 > 0:
            assert ours[cy, 0] == ref[cy, 0] and 35 <= ours[cy, 0] < 55, k


def test_online_benchmark_modes_agree():
    """run_mode on a few CPU frames in sync and in lazy mode: the same
    trajectory (loop closure on, no revisit), positive times."""
    cfg = online_benchmark.bench_config(small=True)
    frames = online_benchmark.make_frames(cfg, 6)
    assert frames[0].shape == (240, 320) and frames[0].dtype == np.uint8
    ms_sync, sync = online_benchmark.run_mode(cfg, frames, 0, warmup=2, device="cpu",
                                              keep_pipe=True)
    ms_lazy, lazy = online_benchmark.run_mode(cfg, frames, 3, warmup=2, device="cpu",
                                              keep_pipe=True)
    assert ms_sync > 0 and ms_lazy > 0
    assert len(lazy.trajectory) == len(sync.trajectory) == len(frames)
    np.testing.assert_array_equal(np.stack([T for _, T in lazy.trajectory]),
                                  np.stack([T for _, T in sync.trajectory]))
