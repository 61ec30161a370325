"""Realtime demo: video-file SLAM loop with trajectory canvas + HUD
(counterpart of the JAX package's eval/demo.py).

Parity: reference `aria_slam` executable (src/main.cpp:68-267): per
frame ORB + matching + (optional) YOLO dynamic filtering + epipolar
pose accumulation, trajectory drawn on a canvas, keypoint/match/
detection overlay, FPS HUD; `--headless` prints stats every 50 frames
instead of rendering.

Video is read and written through OpenCV, which is imported when `run`
starts and is required: without it `run` raises ImportError. The
per-frame body (`frame_step`: the pipeline step, the fps average, the
stats line and the overlay's arrays on the host) needs no OpenCV. The
pipeline runs on CUDA unless `device` says otherwise.

Usage:
    python -m aria_slam_tpu_torch.eval.demo <video.mp4> [--headless]
        [--detect] [--max-frames N] [--out overlay.mp4] [--device cpu]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

STATS_EVERY = 50  # frames between two headless stats lines


def _require_cv2():
    """cv2 is an optional extra (pyproject [cv]): either opencv-python
    or opencv-python-headless satisfies the import."""
    try:
        import cv2
    except ImportError as e:
        raise ImportError(
            "image decode needs OpenCV: pip install 'aria-slam-tpu[cv]' "
            "(or opencv-python-headless on servers/CI)") from e
    return cv2


def frame_step(pipe, gray: np.ndarray, n: int, fps: float, fps_in: float,
               headless: bool = True, overlay: bool = False):
    """One frame of the demo loop: `gray` (H, W) uint8, the n-th frame
    (from 0) at n / fps_in seconds, through pipe.process_frame; fps is the
    running average before it (0.9 old + 0.1 new, the first frame's own
    rate). Headless, prints the stats line at every STATS_EVERY-th frame.
    overlay: also bring the overlay's arrays to the host, the valid
    keypoints (K, 2) of pipe.state.prev_feats and the valid detection
    boxes (D, 4) of last_output.detections. Returns (pose (4, 4) numpy,
    fps, {"keypoints": ..., "boxes": ...} or None)."""
    t0 = time.perf_counter()
    pose = pipe.process_frame(gray, n / fps_in)
    dt = time.perf_counter() - t0
    fps = 0.9 * fps + 0.1 / max(dt, 1e-6) if n else 1.0 / max(dt, 1e-6)
    n += 1
    out = pipe.last_output
    if headless and n % STATS_EVERY == 0:
        print(
            f"[{n}] fps={fps:.1f} feats={int(out.num_features)} "
            f"matches={int(out.num_matches)} inliers={int(out.num_inliers)} "
            f"filtered={int(out.num_filtered)} "
            f"pos=({pose[0,3]:.2f},{pose[1,3]:.2f},{pose[2,3]:.2f})"
        )
    arrays = None
    if overlay:
        feats = pipe.state.prev_feats
        det = out.detections
        arrays = {"keypoints": feats.xy.cpu().numpy()[feats.valid.cpu().numpy()],
                  "boxes": det.boxes.cpu().numpy()[det.valid.cpu().numpy()]}
    return pose, fps, arrays


def run(video_path: str, headless: bool = True, detect: bool = False,
        max_frames: int | None = None, out_path: str | None = None,
        config=None, device=None) -> dict:
    cv2 = _require_cv2()

    from aria_slam_tpu_torch.config import CameraConfig, PipelineConfig
    from aria_slam_tpu_torch.pipeline import factory

    cap = cv2.VideoCapture(video_path)
    if not cap.isOpened():
        raise FileNotFoundError(f"cannot open video: {video_path}")
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    fps_in = cap.get(cv2.CAP_PROP_FPS) or 30.0

    cfg = config or PipelineConfig(
        camera=CameraConfig(width=w, height=h, fx=0.9 * w, fy=0.9 * w,
                            cx=w / 2, cy=h / 2, k1=0, k2=0, p1=0, p2=0),
        enable_detection=detect,
        enable_dynamic_filtering=detect,
        enable_loop_closure=False,  # video demos rarely revisit; parity
        enable_fusion=False,        # with main.cpp's VO-only loop
        enable_mapping=False,
    )
    pipe = factory.create(config=cfg, device=device)

    writer = None
    if out_path:
        writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                                 fps_in, (w, h))

    canvas = np.zeros((360, 360, 3), np.uint8)  # trajectory view
    n = 0
    t_start = time.perf_counter()
    fps = 0.0
    draw = writer is not None or not headless
    while True:
        ok, frame = cap.read()
        if not ok or (max_frames and n >= max_frames):
            break
        gray = cv2.cvtColor(frame, cv2.COLOR_BGR2GRAY)  # uint8: cheap H2D
        pose, fps, arrays = frame_step(pipe, gray, n, fps, fps_in, headless, overlay=draw)
        n += 1
        if draw:
            vis = frame.copy()
            for p in arrays["keypoints"][:500]:
                cv2.circle(vis, (int(p[0]), int(p[1])), 2, (0, 255, 0), -1)
            if detect:
                for b in arrays["boxes"]:
                    cv2.rectangle(vis, (int(b[0]), int(b[1])),
                                  (int(b[2]), int(b[3])), (0, 0, 255), 2)
            # trajectory canvas (x-z plane, like the reference HUD)
            px = int(180 + pose[0, 3] * 5)
            pz = int(180 + pose[2, 3] * 5)
            if 0 <= px < 360 and 0 <= pz < 360:
                cv2.circle(canvas, (px, pz), 1, (255, 200, 0), -1)
            cv2.putText(vis, f"FPS {fps:.1f}  matches {int(pipe.last_output.num_matches)}",
                        (10, 24), cv2.FONT_HERSHEY_SIMPLEX, 0.7, (0, 255, 255), 2)
            if writer is not None:
                writer.write(vis)
            if not headless:
                cv2.imshow("aria_slam_tpu", vis)
                cv2.imshow("trajectory", canvas)
                if cv2.waitKey(1) & 0xFF == ord("q"):
                    break

    cap.release()
    if writer is not None:
        writer.release()
    total = time.perf_counter() - t_start
    stats = {"frames": n, "avg_fps": n / total if total > 0 else 0.0}
    print(f"processed {n} frames, avg fps {stats['avg_fps']:.1f}")
    return stats


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("video")
    ap.add_argument("--headless", action="store_true")
    ap.add_argument("--detect", action="store_true",
                    help="run the object detector + dynamic filtering")
    ap.add_argument("--max-frames", type=int, default=None)
    ap.add_argument("--out", default=None, help="write overlay video")
    ap.add_argument("--device", default=None, help="default: cuda")
    args = ap.parse_args(argv)
    run(args.video, headless=args.headless, detect=args.detect,
        max_frames=args.max_frames, out_path=args.out, device=args.device)


if __name__ == "__main__":
    main()
