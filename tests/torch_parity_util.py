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
