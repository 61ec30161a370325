"""Long-trajectory accuracy benchmark (counterpart of the JAX package's
eval/accuracy_benchmark.py).

A 240-frame rotation-heavy synthetic trajectory with a genuine revisit
(io/synthetic_scene.py, traj="rotloop": the 20 s period brings the camera
back through its start pose with +/-34 degree panning segments) and an
optional occluder, run through euroc_eval in three configurations:

  vo     : monocular VO only (fusion and loop closure off)
  vio    : VO + the 15-state EKF (ate_fused is the VIO track)
  vio_lc : VIO + loop closure + the pose graph

with the reference's ordering gates: the fused track not worse than VO,
loop closure not worse than without, the scale and the rotation RPE kept.

--excited runs the other fusion benchmark: a 10 s period (about 0.8
m/s^2, where the monocular + IMU scale is observable) and a wrong 6 m
depth prior on the 4 m scene, in three configurations, vo (the prior
pins the metric), imu (the IMU scale estimator) and vio (estimator +
EKF), with must-improve gates: the accelerometer has to recover the
metric. It needs chunked mode, where the scale estimator runs.

Usage:
    python -m aria_slam_tpu_torch.eval.accuracy_benchmark [--frames 240]
        [--chunk 16] [--occluder] [--out DIR] [--full-res] [--excited]
    (--chunk 0 runs the online per-frame pipeline; --excited needs
    --chunk >= 2)
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np

from aria_slam_tpu_torch.config import (
    CameraConfig, LoopClosureConfig, MapperConfig, OrbConfig, PipelineConfig, PoseGraphConfig,
    RansacConfig,
)

SMALL_CAM = CameraConfig(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                         k1=0.0, k2=0.0, p1=0.0, p2=0.0)


def benchmark_config(full_res: bool = False, frames: int = 240) -> PipelineConfig:
    """The benchmark's configuration: 752x480 / 2000 features / 8 levels
    (full_res) or 320x240 / 384 / 3, the loop gates 150 frames / 0.3 / 40
    inliers over 512 keyframes, a 100,000-point map, a graph sized for
    `frames`, and the lag-pair scale correction (vo_backbone_scale)."""
    cam = CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0) if full_res else SMALL_CAM
    orb = OrbConfig() if full_res else OrbConfig(num_features=384, num_levels=3)
    return PipelineConfig(
        camera=cam,
        orb=orb,
        ransac=RansacConfig(num_hypotheses=256 if full_res else 128),
        loop=LoopClosureConfig(max_keyframes=512, min_frames_between=150, min_score=0.3,
                               min_matches=40),
        mapper=MapperConfig(max_points=100_000),
        pose_graph=PoseGraphConfig(max_nodes=max(256, frames + 16),
                                   max_edges=max(1024, 3 * frames),
                                   lm_iterations=5, cg_iterations=32),
        vo_backbone_scale=True,
    )


def _run_variants(scene_dir: str, variants: dict, chunk: int, out_root: str,
                  verbose: bool = True, device=None) -> dict:
    from aria_slam_tpu_torch.eval import euroc_eval

    report = {}
    for name, vcfg in variants.items():
        res = euroc_eval.run(scene_dir, out_dir=os.path.join(out_root, name), config=vcfg,
                             verbose=False, chunk=chunk, device=device)
        report[name] = {k: (round(float(v), 4) if isinstance(v, float) else v)
                        for k, v in res.items()}
        if verbose:
            print(f"[{name}] {json.dumps(report[name])}", flush=True)
    return report


def run_benchmark(scene_dir: str, cfg: PipelineConfig, chunk: int, out_root: str,
                  verbose: bool = True, device=None) -> dict:
    return _run_variants(scene_dir, {
        "vo": dataclasses.replace(cfg, enable_fusion=False, enable_loop_closure=False),
        "vio": dataclasses.replace(cfg, enable_loop_closure=False),
        "vio_lc": cfg,
    }, chunk, out_root, verbose, device)


def run_excited(scene_dir: str, cfg: PipelineConfig, chunk: int, out_root: str,
                verbose: bool = True, device=None) -> dict:
    """The wrong-prior fusion benchmark on the excited scene: vo (fusion
    and the scale estimator off, the wrong prior pins the metric), imu
    (the scale estimator only), vio (estimator + EKF)."""
    return _run_variants(scene_dir, {
        "vo": dataclasses.replace(cfg, enable_fusion=False, imu_metric_scale=False),
        "imu": dataclasses.replace(cfg, enable_fusion=False, imu_metric_scale=True),
        "vio": dataclasses.replace(cfg, enable_fusion=True, imu_metric_scale=True),
    }, chunk, out_root, verbose, device)


def excited_ordering(report: dict) -> dict:
    """The excited benchmark's must-improve gates (the reference's): the
    IMU scale closer to metric than the wrong prior's, its rigid ATE
    strictly better, vio's scale within 8 % (|log s| < 0.08), the EKF's
    own track strictly better than vo on the rigid and raw ATE, and not
    worse than imu's chain by more than 10 % + 1 cm."""
    sp, si, sv = (report[k]["umeyama_scale"] for k in ("vo", "imu", "vio"))
    fused_ns = report["vio"].get("ate_fused_noscale_rmse_m")
    fused_raw = report["vio"].get("ate_fused_raw_rmse_m")
    return {
        "imu_scale_closer_to_metric": bool(abs(np.log(si)) < abs(np.log(sp))),
        "imu_noscale_ate_strictly_better":
            bool(report["imu"]["ate_noscale_rmse_m"] < report["vo"]["ate_noscale_rmse_m"]),
        "vio_scale_metric_8pct": bool(abs(np.log(sv)) < 0.08),
        "vio_fused_noscale_ate_strictly_better":
            bool(fused_ns is not None and fused_ns < report["vo"]["ate_noscale_rmse_m"]),
        "vio_fused_raw_ate_strictly_better":
            bool(fused_raw is not None and fused_raw < report["vo"]["ate_raw_rmse_m"]),
        "vio_fused_not_worse_than_imu":
            bool(fused_ns is not None
                 and fused_ns <= report["imu"]["ate_noscale_rmse_m"] * 1.10 + 0.01),
    }


def benchmark_ordering(report: dict) -> dict:
    """The rotloop benchmark's gates (the reference's margins; None where
    a metric is missing for lack of ground truth)."""
    vio, lc = report["vio"], report["vio_lc"]
    ate_vo = report["vo"]["ate_rmse_m"]
    s_vio = vio.get("umeyama_scale", float("nan"))
    s_lc = lc.get("umeyama_scale", float("nan"))
    return {
        "vio_fused_not_worse": vio.get("ate_fused_rmse_m", 1e9) <= ate_vo * 1.10 + 0.02,
        "fused_beats_optimized_chain": bool(lc.get("ate_fused_rmse_m", 1e9)
                                            <= lc["ate_rmse_m"] + 1e-3),
        "fused_beats_optimized_chain_raw": bool(lc.get("ate_fused_raw_rmse_m", 1e9)
                                                <= lc["ate_raw_rmse_m"] + 1e-3),
        "lc_not_worse": lc["ate_rmse_m"] <= vio["ate_rmse_m"] * 1.15 + 0.02,
        "lc_scale_within_5pct_of_vio": (bool(abs(np.log(s_lc / s_vio)) < 0.05)
                                        if np.isfinite(s_lc) and np.isfinite(s_vio) else None),
        "lc_noscale_not_worse": (
            bool(lc["ate_noscale_rmse_m"] <= vio["ate_noscale_rmse_m"] * 1.05 + 0.01)
            if "ate_noscale_rmse_m" in lc and "ate_noscale_rmse_m" in vio else None),
        "lc_rot_rpe_not_twisted": bool(lc["rpe_rot_deg"] <= vio["rpe_rot_deg"] * 1.5 + 0.02),
        "loops_found": lc["loops"],
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--fps", type=float, default=10.0)
    ap.add_argument("--chunk", type=int, default=16, help="0 = online per-frame mode")
    ap.add_argument("--occluder", action="store_true")
    ap.add_argument("--full-res", action="store_true", help="752x480 / 2000 features")
    ap.add_argument("--excited", action="store_true",
                    help="high-excitation wrong-prior fusion benchmark (see the docstring)")
    ap.add_argument("--out", default="accuracy_benchmark_out")
    ap.add_argument("--scene", default=None, help="reuse an existing generated scene dir")
    ap.add_argument("--device", default=None, help="torch device (default: CUDA)")
    args = ap.parse_args(argv)

    from aria_slam_tpu_torch.io import synthetic_scene

    if args.excited and args.chunk <= 1:
        # chunk <= 1 is the online per-frame mode, where the IMU scale
        # estimator (the chunked evaluator's) never runs
        ap.error("--excited requires chunked mode (--chunk >= 2): the IMU scale estimator "
                 "rides the chunked evaluator")

    cfg = benchmark_config(args.full_res, args.frames)
    period = 10.0 if args.excited else 20.0
    scene = args.scene or os.path.join(
        args.out, f"scene_{args.frames}{'_occ' if args.occluder else ''}"
        f"{'_full' if args.full_res else ''}{'_exc' if args.excited else ''}")
    if not os.path.exists(os.path.join(scene, "mav0")):
        synthetic_scene.generate(scene, num_frames=args.frames, fps=args.fps, cam=cfg.camera,
                                 depth=4.0, traj="rotloop", period=period,
                                 occluder=args.occluder)
        print(f"scene generated: {scene}", flush=True)

    if args.excited:
        cfg = dataclasses.replace(cfg, vo_scene_depth=6.0,  # wrong on purpose (true 4 m)
                                  enable_loop_closure=False)
        report = run_excited(scene, cfg, args.chunk, args.out, device=args.device)
        report["meta"] = {
            "frames": args.frames, "fps": args.fps, "chunk": args.chunk,
            "full_res": args.full_res, "period_s": period, "prior_depth_m": 6.0,
            "true_depth_m": 4.0, "peak_accel_ms2": "~0.8 (10 s period, 2 m span)",
            "gates": "must-improve: the excitation makes the scale observable",
        }
        if "umeyama_scale" not in report["vo"]:
            raise SystemExit("--excited needs a scene with ground truth "
                             "(umeyama_scale missing from the evaluation)")
        report["ordering"] = excited_ordering(report)
    else:
        report = run_benchmark(scene, cfg, args.chunk, args.out, device=args.device)
        report["meta"] = {
            "frames": args.frames, "fps": args.fps, "chunk": args.chunk,
            "occluder": args.occluder, "full_res": args.full_res,
            "path_length_m": "~9.5 (2 m span sweep + rotations, 20 s period)",
        }
        report["ordering"] = benchmark_ordering(report)
    with open(os.path.join(args.out, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps(report, indent=1))
    return report


if __name__ == "__main__":
    main()
