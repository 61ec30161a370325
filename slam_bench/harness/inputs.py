"""Inputs: the mixes' scenes and IMU streams, the detector's weights drawn
from the seed, and the recording RANSAC sampler."""

from __future__ import annotations

import numpy as np
import torch

from slam_bench.scene import render


def rng(seed: int, *stream) -> np.random.Generator:
    """numpy Generator of (seed, *stream): one independent stream each."""
    return np.random.default_rng([int(seed) & (2**63 - 1), *stream])


def sub_seed(seed: int, *stream) -> int:
    return int(np.random.SeedSequence([int(seed) & (2**63 - 1), *stream]).generate_state(1)[0])


def camera(cfg: dict) -> render.Camera:
    c = cfg["pipeline"]["camera"]
    return render.Camera(c["width"], c["height"], c["fx"], c["fy"], c["cx"], c["cy"])


def scene(cam, traffic: dict, seed: int, index: int, frames: int, device):
    """(frames (F, H, W) uint8 host, times (F,), ground-truth positions
    (F, 3), IMU (ts, accel, gyro)) of scene `index` of the mix, drawn from
    (seed, index): its layers' textures, the moving panel's texture and
    the IMU's noise. Every scene of a mix has the same trajectory, size
    and length, so seeds change the pictures and not the amount of work."""
    r = rng(seed, 1, index)
    depth = traffic["depth"]
    layers = render.layers_drawn(depth, r)
    moving = None
    if traffic.get("moving_object"):
        mo = traffic["moving_object"]
        moving = (render.texture_drawn(512, r), mo["size"], mo["speed"])
    times = np.arange(frames) / traffic["fps"]
    imgs = render.render(cam, times, layers, kind=traffic["kind"], period=traffic["period"],
                         depth=depth, moving=moving, device=device)
    pos, _ = render.trajectory(times, depth=depth, kind=traffic["kind"], period=traffic["period"])
    imu = render.imu_samples(traffic["imu_seconds"], traffic["imu_hz"], sub_seed(seed, 2, index),
                             depth, traffic["kind"], traffic["period"])
    return imgs, times, pos, imu


def yolo_weights(det: dict, seed: int, device) -> dict:
    """The detector's tensors by name, drawn on the device from the seed:
    lecun-normal kernels (std 1 / sqrt(fan-in)), zero biases, batch norm
    at scale 1, bias 0, mean 0, variance 1 (the JAX package's
    initialisation), in float32. One normal draw fills every kernel."""
    from slam_bench.reference import yolo

    plist = yolo.params(det["width_mult"], det["depth_mult"], det["num_classes"])
    gen = torch.Generator(device=device)
    gen.manual_seed(sub_seed(seed, 3))
    kernels = [(n, s) for n, s, k in plist if k == "kernel"]
    flat = torch.randn(sum(int(np.prod(s)) for _, s in kernels), generator=gen, device=device)
    W, off = {}, 0
    for n, s in kernels:
        size = int(np.prod(s))
        W[n] = flat[off: off + size].reshape(s) / float(np.sqrt(s[1] * s[2] * s[3]))
        off += size
    for n, s, k in plist:
        if k != "kernel":
            fill = 1.0 if k in ("bn_scale", "bn_var") else 0.0
            W[n] = torch.full(s, fill, device=device)
    return W


class RecordingSampler:
    """Wraps a RANSAC sampler and keeps each call's (stage, valid, draws),
    in call order."""

    def __init__(self, sampler):
        self.sampler = sampler
        self.calls = []

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        idx = self.sampler(valid, num_hypotheses, sample_size, stage)
        self.calls.append((stage, valid, idx))
        return idx
