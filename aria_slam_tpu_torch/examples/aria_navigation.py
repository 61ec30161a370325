"""End-to-end navigation-assistance loop (counterpart of the repository's
examples/aria_navigation.py, the JAX package's wiring).

The reference's product loop: Aria glasses stream -> SLAM -> object
detection -> spatial audio guidance for visually impaired users, with a
scene narrator on the side. The same loop from the port's parts:

    MockAriaDevice (or a real adapter implementing the AriaDevice port)
        -> AsyncSlamPipeline (native SPSC staged executor: decode,
           dispatch, collect threads)
        -> NavigationAudioEngine (direction / priority / cooldown guidance)
        -> AsyncSceneWorker (drop-oldest scene narrator)

The pipeline runs on the card unless `run` is given device="cpu"; its
frame step is launched from the executor's dispatch thread. The
configuration is the example's: the camera from the device's
calibration (fx = fy = 0.9 w, the principal point at the centre, no
distortion), 512 features on 4 levels, 128 RANSAC hypotheses, detection
and dynamic filtering with --detect, loop closure and mapping off,
frames dropped when 4 wait to be decoded. The detector has the JAX
package's random weights (yolo.init_model) unless the config names an
npz. Two behaviours of the JAX example are kept as they are: the
warm-up frame at timestamp -1.0 becomes the pipeline's time origin, so
the stream's epoch timestamps are about 1.7e9 s from it (float32 holds
them to 128 s); and the guidance of a collected frame reads
pipe.last_output, which may already belong to a later frame that the
dispatch thread has stepped.

A stage, the device's streaming thread or the narrator that raises
fails the run: `run` raises, and the CLI exits non-zero.

Run:  python -m aria_slam_tpu_torch.examples.aria_navigation <image_dir>
      [--detect] [--interval 0.033]
(any directory of .png frames; try a synthetic scene's mav0/cam0/data)
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np


def run(image_dir: str, detect: bool = False, interval: float = 0.033, *,
        device=None, verbose: bool = True) -> dict:
    """The loop over image_dir's PNGs streamed every `interval` seconds.
    Returns the counts: frames submitted, processed and dropped, the
    (timestamp, pose) results, audio calls and events, the narrator's
    descriptions, IMU samples emitted, consumed and still buffered (the
    rest were lost, see SlamPipeline._drain_imu), each collected frame's
    stage times (`stage_ms`: decode, dispatch, collect and the
    submit-to-collect latency, ms), the wall time from the stream's start
    to the last result, and whether the fused pose stayed finite."""
    from aria_slam_tpu_torch.config import CameraConfig, OrbConfig, PipelineConfig, RansacConfig
    from aria_slam_tpu_torch.io.aria import MockAriaDevice
    from aria_slam_tpu_torch.models.vlm import AsyncSceneWorker, MockSceneUnderstanding
    from aria_slam_tpu_torch.pipeline import factory
    from aria_slam_tpu_torch.pipeline.async_pipeline import AsyncSlamPipeline
    from aria_slam_tpu_torch.utils.audio import ConsoleAudioFeedback, NavigationAudioEngine

    # --- device (swap MockAriaDevice for a real AriaDevice implementation)
    aria = MockAriaDevice(image_dir, interval_s=interval, imu_hz=200.0)
    if not aria.connect():
        raise FileNotFoundError(f"no frames found in {image_dir}")
    cal = aria.get_calibration("slam-left")

    cfg = PipelineConfig(
        camera=CameraConfig(width=cal.width, height=cal.height, fx=cal.fx, fy=cal.fy,
                            cx=cal.cx, cy=cal.cy, k1=0, k2=0, p1=0, p2=0),
        orb=OrbConfig(num_features=512, num_levels=4),
        ransac=RansacConfig(num_hypotheses=128),
        enable_detection=detect,
        enable_dynamic_filtering=detect,
        enable_loop_closure=False,
        enable_mapping=False,
    )
    pipe = factory.create(config=cfg, device=device)

    # --- guidance + narrator
    audio = NavigationAudioEngine(ConsoleAudioFeedback(), image_width=cal.width)
    narrator = AsyncSceneWorker(MockSceneUnderstanding())
    counts = {"audio_calls": 0, "audio_events": 0, "imu_emitted": 0}

    def on_result(ts, pose):
        out = pipe.last_output
        if verbose:
            print(f"[{ts:.2f}] pos=({pose[0, 3]:+.2f},{pose[1, 3]:+.2f},"
                  f"{pose[2, 3]:+.2f}) matches={int(out.num_matches)}")
        if detect:
            det = out.detections  # on the step's device: one copy to the host
            counts["audio_events"] += len(audio.process_detections(det.boxes, det.classes,
                                                                    det.valid))
            counts["audio_calls"] += 1

    async_pipe = AsyncSlamPipeline(pipe, drop_threshold=4, on_result=on_result)
    submitted = 0

    # --- stream
    def on_image(ts, image, camera_id):
        nonlocal submitted
        submitted += 1
        async_pipe.submit(ts, image=image)
        narrator.submit(ts, image)

    def on_imu(ts, accel, gyro):
        counts["imu_emitted"] += 1
        pipe.process_imu(ts, accel, gyro)

    aria.set_image_callback(on_image)
    aria.set_imu_callback(on_imu)

    try:
        if verbose:
            print("warming up (kernel builds, the first step's allocations)...")
        # the first step on the main thread: the real-time loop never
        # stalls on a build, and the dispatch thread finds the kernels loaded
        pipe.process_frame(np.zeros((cal.height, cal.width), np.float32), -1.0)

        aria.start_streaming()
        t_start = t0 = time.time()
        while aria._thread is not None and aria._thread.is_alive():
            aria.spin_once(0.1)
            desc = narrator.latest()
            if desc and time.time() - t0 > 2.0:
                if verbose:
                    print(f"[scene] {desc.text}")
                t0 = time.time()
        aria.stop_streaming()
        results = async_pipe.drain()
        wall_s = time.time() - t_start
        stats = async_pipe.stats()
    finally:
        async_pipe.close()
        narrator.close()
    if verbose:
        print(f"processed {len(results)} frames "
              f"(dropped {stats['dropped'][0]} under backpressure)")
    return dict(submitted=submitted, processed=len(results), dropped=stats["dropped"][0],
                results=results, descriptions=narrator.described,
                imu_consumed=pipe.imu_consumed, imu_buffered=len(pipe._imu_buf),
                stage_ms=list(async_pipe.timings),
                wall_s=wall_s, fused_finite=bool(np.isfinite(pipe.fused_pose).all()),
                **counts)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("image_dir", help="directory of frames to replay")
    ap.add_argument("--detect", action="store_true",
                    help="run the object detector + audio guidance")
    ap.add_argument("--interval", type=float, default=0.033)
    args = ap.parse_args()
    try:
        run(args.image_dir, args.detect, args.interval)
    except FileNotFoundError as e:
        print(e, file=sys.stderr)
        sys.exit(1)


if __name__ == "__main__":
    main()
