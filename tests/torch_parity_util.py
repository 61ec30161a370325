"""Shared helpers of the tests/test_torch_*.py parity tests: the small
configuration of tests/test_pipeline.py for both packages, and RANSAC
samplers that make the JAX package's own jax.random draws so the port's
estimators see the same minimal samples."""

from __future__ import annotations

import numpy as np
import torch

import jax
import jax.numpy as jnp

from aria_slam_tpu import config as jcfg
from aria_slam_tpu_torch import config as tcfg

# the per-file budget is small and tier-1 runs six xdist workers at once
torch.set_num_threads(2)


def small_config(module, **overrides):
    """tests/test_pipeline.py's SMALL_CFG (VO-only), built from `module`
    (either package's config module)."""
    cam = module.CameraConfig(width=320, height=240, fx=200.0, fy=200.0,
                              cx=160.0, cy=120.0, k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    kw = dict(
        camera=cam,
        orb=module.OrbConfig(num_features=384, num_levels=3),
        ransac=module.RansacConfig(num_hypotheses=128),
        pose_graph=module.PoseGraphConfig(max_nodes=64, max_edges=128,
                                          lm_iterations=5, cg_iterations=24),
        enable_loop_closure=False, enable_detection=False,
        enable_fusion=False, enable_mapping=False,
    )
    kw.update(overrides)
    return module.PipelineConfig(**kw)


JAX_SMALL_CFG = small_config(jcfg)
TORCH_SMALL_CFG = small_config(tcfg)


class JaxKeySampler:
    """The JAX package's draws for one estimate_relative_pose call: the
    essential stage from `key`, the homography stage from
    fold_in(key, 77) (ops/epipolar.py _sample_indices)."""

    def __init__(self, key):
        self.key = key

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        key = self.key if stage == "essential" else jax.random.fold_in(self.key, 77)
        logits = jnp.where(jnp.asarray(valid.cpu().numpy()), 0.0, -1e30)
        flat = jax.random.categorical(key, logits, shape=(num_hypotheses * sample_size,))
        idx = np.asarray(flat).astype(np.int64).reshape(num_hypotheses, sample_size)
        return torch.from_numpy(idx).to(valid.device)


class JaxChainSampler(JaxKeySampler):
    """The JAX pipeline's key chain: every frame step splits the carried
    key into (key, k_ransac, k_loop) and RANSAC draws from k_ransac."""

    def __init__(self, key):
        super().__init__(None)
        self.chain = key

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        if stage == "essential":
            self.chain, self.key, _ = jax.random.split(self.chain, 3)
        return super().__call__(valid, num_hypotheses, sample_size, stage)


class JaxPairsSampler:
    """The JAX chunked front end's draws for one chunk: its key k1 split
    into one key a consecutive pair, fold_in(k1, 1) split into one key a
    lag pair (eval/chunked.py), and inside each pair the essential stage
    from the pair's key, the homography stage from fold_in(key, 77). The
    port solves the consecutive pairs and then the lag pairs in one
    batch, so the keys are concatenated in that order."""

    def __init__(self, key, c: int, nlag: int):
        keys = [jax.random.key_data(jax.random.split(key, c))]
        if nlag:
            keys.append(jax.random.key_data(jax.random.split(jax.random.fold_in(key, 1), nlag)))
        self.keys = jax.random.wrap_key_data(jnp.concatenate(keys))

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        keys = self.keys
        if stage != "essential":
            keys = jax.vmap(lambda k: jax.random.fold_in(k, 77))(keys)
        logits = jnp.where(jnp.asarray(valid.cpu().numpy()), 0.0, -1e30)
        assert logits.shape[0] == keys.shape[0], (logits.shape, keys.shape)
        flat = jax.vmap(lambda k, lg: jax.random.categorical(
            k, lg, shape=(num_hypotheses * sample_size,)))(keys, logits)
        idx = np.asarray(flat).astype(np.int64).reshape(-1, num_hypotheses, sample_size)
        return torch.from_numpy(idx).to(valid.device)


class JaxChunkChainSampler:
    """The JAX ChunkedSlam's key chain: process_chunk splits its carried
    key into (key, k1, k2) every chunk and the front end draws from k1
    (JaxPairsSampler). `lag` tells the consecutive from the lag pairs in
    the port's one batch of c + (c + 1 - lag) pairs; lag = 0: no lag pairs."""

    def __init__(self, key, lag: int):
        self.chain = key
        self.lag = lag
        self.inner = None

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        if stage == "essential":
            self.chain, k1, _ = jax.random.split(self.chain, 3)
            b = valid.shape[0]
            c = (b + self.lag - 1) // 2 if self.lag else b
            self.inner = JaxPairsSampler(k1, c, b - c)
        return self.inner(valid, num_hypotheses, sample_size, stage)


def to_np(tree):
    """A JAX pytree as numpy leaves (typed PRNG keys as their key data)."""
    def leaf(x):
        if jnp.issubdtype(x.dtype, jax.dtypes.prng_key):
            return np.asarray(jax.random.key_data(x))
        return np.array(x)
    return jax.tree_util.tree_map(leaf, tree)


def rendered_frames(n: int, fps: float = 5.0, t0: float = 0.0) -> np.ndarray:
    """(n, 240, 320) float32 frames of the multi-depth synthetic scene at
    the small camera, rendered by the JAX package's own (OpenCV) renderer."""
    from aria_slam_tpu.io import synthetic_scene

    layers = synthetic_scene.scene_layers(4.0, 0)
    out = []
    for k in range(n):
        pos, R = synthetic_scene.trajectory(t0 + k / fps)
        out.append(synthetic_scene.render_frame(JAX_SMALL_CFG.camera, None, pos, R,
                                                layers=layers))
    return np.stack(out).astype(np.float32)


def chunk_scene(n: int, fps: float = 5.0):
    """n uint8 frames of the multi-depth scene at the small camera, their
    timestamps, the ground-truth positions, the 200 Hz IMU stream and the
    per-pair gyro rotation priors (the JAX package's renderer and
    integrator, the port's numpy copy of the IMU generator)."""
    from aria_slam_tpu.fusion import gyro_prior
    from aria_slam_tpu.io import synthetic_scene
    from aria_slam_tpu_torch.io import synthetic_scene as tsynth

    layers = synthetic_scene.scene_layers(4.0, 0)
    frames, gt = [], []
    for k in range(n):
        pos, R = synthetic_scene.trajectory(k / fps)
        frames.append(synthetic_scene.render_frame(JAX_SMALL_CFG.camera, None, pos, R,
                                                   layers=layers))
        gt.append(pos)
    ts = np.arange(n) / fps
    imu = tsynth.imu_samples(n / fps)  # numpy, seeded
    Rg, okg = gyro_prior.pair_rotations(imu[0], imu[2], ts)
    return np.stack(frames).astype(np.uint8), ts, np.stack(gt), imu, Rg, okg

