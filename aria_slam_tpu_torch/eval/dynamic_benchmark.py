"""Dynamic-object filtering, proven end to end (counterpart of the JAX
package's eval/dynamic_benchmark.py).

The reference drops feature matches inside YOLO boxes of dynamic classes
(src/main.cpp:29-50,164-175). With no COCO checkpoint at hand, this
benchmark closes the loop on its own data:

  1. render a scene with an independently moving textured panel
     (io/synthetic_scene.moving_object_state) whose features pollute the
     RANSAC consensus, and its object-free twin;
  2. train the tiny detector to find that panel (class 0 == COCO person,
     a DYNAMIC_CLASS_IDS member) from the scene's ground-truth boxes
     (models/detector_train.train_on_scene); detection emerges late, after
     an all-background plateau of about 250 steps at lr 3e-3;
  3. run the chunked evaluator three ways: the clean twin, the object
     scene with filtering off, and with filtering on through the trained
     detector (config.detector_weights in the chunk front end).

Default object (size 2.2, speed 2.8): the panel covers about half the
view and moves fast enough that its features form their own epipolar
consensus. The gyro-backed IRLS chain holds rotation against it; the
damage lands in the metric scale chain (a coherently moving plane passes
the two-view gates and biases the median-depth pins), which box
filtering defends. The verdict therefore tracks the Umeyama scale error
and the scale-fixed ATE, plus rotation as a no-regression guard.

The weights are the JAX package's npz (yolo.save_weights), so either
package reads the other's file.

Usage:
    python -m aria_slam_tpu_torch.eval.dynamic_benchmark [--frames 96]
        [--steps 800] [--chunk 16] [--full-res] [--out DIR] [--device cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import tempfile

from aria_slam_tpu_torch.config import (
    CameraConfig, DetectorConfig, OrbConfig, PipelineConfig, RansacConfig,
)

SMALL_CAM = CameraConfig(width=320, height=240, fx=200.0, fy=200.0,
                         cx=160.0, cy=120.0, k1=0.0, k2=0.0, p1=0.0, p2=0.0)

# tiny detector: 160 px input, 0.25 width; 2 classes (the object and a
# background distractor slot)
TINY_DET = DetectorConfig(input_size=160, width_mult=0.25, depth_mult=0.33,
                          num_classes=2, conf_threshold=0.4,
                          max_detections=16)


def base_config(full_res: bool = False) -> PipelineConfig:
    return PipelineConfig(
        camera=CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0) if full_res
        else SMALL_CAM,
        orb=OrbConfig() if full_res else OrbConfig(num_features=384,
                                                   num_levels=3),
        ransac=RansacConfig(num_hypotheses=256 if full_res else 128),
        detector=TINY_DET,
        enable_loop_closure=False,
        enable_mapping=False,
        enable_fusion=False,
    )


def verdict(report: dict) -> dict:
    """The reference's verdict over the three runs' rounded reports: the
    object's corruption and the filter's recovery of the scale-fixed ATE
    and of the rotation RPE, both runs' |log s|, and filtering_helps
    (|log s| cut by 25 % and the scale-fixed ATE no more than 5 % worse)."""
    off = report["object_nofilter"]
    on = report["object_filtered"]
    clean = report["clean"]
    return {
        "corruption_x": round(off["ate_noscale_rmse_m"]
                              / max(clean["ate_noscale_rmse_m"], 1e-6), 2),
        "recovery_x": round(off["ate_noscale_rmse_m"]
                            / max(on["ate_noscale_rmse_m"], 1e-6), 2),
        "rot_corruption_x": round(off["rpe_rot_deg"]
                                  / max(clean["rpe_rot_deg"], 1e-6), 2),
        "rot_recovery_x": round(off["rpe_rot_deg"]
                                / max(on["rpe_rot_deg"], 1e-6), 2),
        "scale_err_off": round(abs(math.log(off["umeyama_scale"])), 4),
        "scale_err_on": round(abs(math.log(on["umeyama_scale"])), 4),
        "filtering_helps": bool(
            abs(math.log(on["umeyama_scale"]))
            < abs(math.log(off["umeyama_scale"])) * 0.75
            and on["ate_noscale_rmse_m"]
            <= off["ate_noscale_rmse_m"] * 1.05),
    }


def run(out_root: str | None = None, frames: int = 96, steps: int = 800, chunk: int = 16,
        full_res: bool = False, object_size: float = 2.2, object_speed: float = 2.8,
        verbose: bool = True, device=None) -> dict:
    """The three runs and the verdict, written to out_root/report.json
    (out_root default: dynamic_benchmark under the temporary directory).
    Scenes are generated only when their mav0 is missing, the detector
    trained only when object_detector.npz is missing. device: CUDA unless
    given (training and the three evaluator runs)."""
    from aria_slam_tpu_torch.eval import euroc_eval
    from aria_slam_tpu_torch.io import synthetic_scene
    from aria_slam_tpu_torch.models import detector_train, yolo

    out_root = out_root or os.path.join(tempfile.gettempdir(), "dynamic_benchmark")
    cfg = base_config(full_res)
    scenes = {}
    for name, kw in [("clean", {}),
                     ("object", dict(moving_object=True,
                                     object_size=object_size,
                                     object_speed=object_speed))]:
        d = os.path.join(out_root, f"scene_{name}")
        if not os.path.exists(os.path.join(d, "mav0")):
            synthetic_scene.generate(
                d, num_frames=frames, fps=10.0, cam=cfg.camera, depth=4.0,
                traj="sweep", period=10.0, **kw)
        scenes[name] = d

    weights = os.path.join(out_root, "object_detector.npz")
    if not os.path.exists(weights):
        if verbose:
            print("training the object detector on the scene...", flush=True)
        model = detector_train.train_on_scene(cfg.detector, scenes["object"], steps=steps,
                                              verbose=verbose, device=device)
        yolo.save_weights(model, weights)

    report = {}
    runs = {
        "clean": (scenes["clean"], cfg),
        "object_nofilter": (scenes["object"], cfg),
        "object_filtered": (scenes["object"], dataclasses.replace(
            cfg, enable_detection=True, enable_dynamic_filtering=True,
            detector_weights=weights)),
    }
    for name, (scene, rcfg) in runs.items():
        res = euroc_eval.run(scene, out_dir=os.path.join(out_root, name),
                             config=rcfg, verbose=False, chunk=chunk, device=device)
        report[name] = {k: (round(float(v), 4) if isinstance(v, float)
                            else v) for k, v in res.items()}
        if verbose:
            print(f"[{name}] {json.dumps(report[name])}", flush=True)

    report["verdict"] = verdict(report)
    with open(os.path.join(out_root, "report.json"), "w") as f:
        json.dump(report, f, indent=1)
    if verbose:
        print(json.dumps(report["verdict"]))
    return report


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=96)
    ap.add_argument("--steps", type=int, default=800)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--full-res", action="store_true")
    ap.add_argument("--out", default=None,
                    help="output directory (default: dynamic_benchmark under the "
                         "temporary directory)")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    run(args.out, args.frames, args.steps, args.chunk, args.full_res, device=args.device)


if __name__ == "__main__":
    main()
