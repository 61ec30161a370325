"""Shared helpers of the tests/test_torch_*.py parity tests: the small
configuration of tests/test_pipeline.py for both packages, and RANSAC
samplers that make the JAX package's own jax.random draws so the port's
estimators see the same minimal samples."""

from __future__ import annotations

import functools

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

# The online slice's scene (tests/test_torch_online.py and
# tests/test_torch_drivers.py): the sweep of tests/test_online_pipelined.py
# (2 s period), rendered at 10.2 fps so that no revisit is exact: at a
# zero-baseline revisit the online verification's cheirality gate (no
# rotation-only rescue) is decided by float32 rounding, in either package.
# Frames 20-23 revisit frames 0-3 from 0.16-0.30 m away.
ONLINE_SCENE = dict(num_frames=24, fps=10.2, period=2.0, depth=4.0)
ONLINE_SEED = 2  # both packages take the same RANSAC branch at every pair


def online_config(module, **overrides):
    """The small configuration with every feature of the online step on:
    fusion, mapping and loop closure (tests/test_online_pipelined.py's
    loop gates and a 32-slot ring)."""
    kw = dict(enable_loop_closure=True, enable_mapping=True, enable_fusion=True,
              loop=module.LoopClosureConfig(max_keyframes=32, min_frames_between=8,
                                            min_score=0.2, min_matches=25),
              mapper=module.MapperConfig(max_points=5000),
              pose_graph=module.PoseGraphConfig(max_nodes=64, max_edges=128, lm_iterations=5,
                                                cg_iterations=24, final_lm_iterations=10))
    kw.update(overrides)
    return small_config(module, **kw)


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
    key into (key, k_ransac, k_loop), RANSAC draws from k_ransac, and the
    loop verification of candidate i (stages "loop_essential" /
    "loop_homography", the candidates on the leading axis) from
    split(k_loop, top_k)[i]."""

    def __init__(self, key):
        super().__init__(None)
        self.chain = key
        self.k_loop = None
        self.loop = None

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        if stage == "essential":
            self.chain, self.key, self.k_loop = jax.random.split(self.chain, 3)
        elif stage == "loop_essential":
            self.loop = JaxPairsSampler(self.k_loop, valid.shape[0], 0)
        if stage.startswith("loop_"):
            return self.loop(valid, num_hypotheses, sample_size, stage.removeprefix("loop_"))
        return super().__call__(valid, num_hypotheses, sample_size, stage)


# pair draws run in batches of this many rows: one compile a stage for
# every batch size up to it (rows are drawn from their own keys, so the
# padding rows change no draw)
_DRAW_ROWS = 16


@functools.partial(jax.jit, static_argnums=(2, 3))
def _pair_draws(key_data, valid, n: int, homography: bool):
    keys = jax.random.wrap_key_data(key_data)
    if homography:
        keys = jax.vmap(lambda k: jax.random.fold_in(k, 77))(keys)
    logits = jnp.where(valid, 0.0, -1e30)
    return jax.vmap(lambda k, lg: jax.random.categorical(k, lg, shape=(n,)))(keys, logits)


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
        self.key_data = np.concatenate(keys)

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        b = valid.shape[0]
        assert b == self.key_data.shape[0], (valid.shape, self.key_data.shape)
        pad = ((0, -b % _DRAW_ROWS), (0, 0))
        flat = _pair_draws(np.pad(self.key_data, pad), np.pad(valid.cpu().numpy(), pad),
                           num_hypotheses * sample_size, stage != "essential")[:b]
        idx = np.asarray(flat).astype(np.int64).reshape(-1, num_hypotheses, sample_size)
        return torch.from_numpy(idx).to(valid.device)


class JaxChunkChainSampler:
    """The JAX ChunkedSlam's key chain: process_chunk splits its carried
    key into (key, k1, k2) every chunk, the front end draws from k1
    (JaxPairsSampler) and the loop verification's V padded pairs from
    split(k2, V) (stages "loop_essential" / "loop_homography"). `lag`
    tells the consecutive from the lag pairs in the port's one batch of
    c + (c + 1 - lag) pairs; lag = 0: no lag pairs."""

    def __init__(self, key, lag: int):
        self.chain = key
        self.lag = lag
        self.inner = None
        self.k2 = None

    def __call__(self, valid, num_hypotheses, sample_size, stage):
        if stage == "essential":
            self.chain, k1, self.k2 = jax.random.split(self.chain, 3)
            b = valid.shape[0]
            c = (b + self.lag - 1) // 2 if self.lag else b
            self.inner = JaxPairsSampler(k1, c, b - c)
        elif stage == "loop_essential":
            self.inner = JaxPairsSampler(self.k2, valid.shape[0], 0)
        return self.inner(valid, num_hypotheses, sample_size, stage.removeprefix("loop_"))


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


def chunk_scene(n: int, fps: float = 5.0, period: float = 20.0):
    """n uint8 frames of the multi-depth scene at the small camera along
    the sweep of the given period, their timestamps, the ground-truth
    positions, the 200 Hz IMU stream and the per-pair gyro rotation
    priors (the JAX package's renderer and integrator, the port's numpy
    copy of the IMU generator)."""
    from aria_slam_tpu.fusion import gyro_prior
    from aria_slam_tpu.io import synthetic_scene
    from aria_slam_tpu_torch.io import synthetic_scene as tsynth

    layers = synthetic_scene.scene_layers(4.0, 0)
    frames, gt = [], []
    for k in range(n):
        pos, R = synthetic_scene.trajectory(k / fps, period=period)
        frames.append(synthetic_scene.render_frame(JAX_SMALL_CFG.camera, None, pos, R,
                                                   layers=layers))
        gt.append(pos)
    ts = np.arange(n) / fps
    imu = tsynth.imu_samples(n / fps, period=period)  # numpy, seeded
    Rg, okg = gyro_prior.pair_rotations(imu[0], imu[2], ts)
    return np.stack(frames).astype(np.uint8), ts, np.stack(gt), imu, Rg, okg



def tiny_detector_npz(path: str, seed: int = 3) -> str:
    """A TINY detector (64 px input, width 0.25) whose head fires the same
    way in both packages, written by the JAX package's yolo.save_weights:
    random backbone weights, and the head's last convolutions zero but for
    their biases, so that every anchor scores sigmoid(3) = 0.953 on class
    0 (person, a dynamic class; -3 on the others) with a box of 1.5
    strides on each side of its centre. At a gate of 0.9 every anchor
    passes with the same score, and the lower-index-first order picks the
    first max_detections of stride 8 (the top rows of the frame): the
    detections do not depend on bf16 rounding, so both packages give the
    same boxes. Returns path."""
    import flax.traverse_util as tu

    from aria_slam_tpu.config import DetectorConfig
    from aria_slam_tpu.models import yolo

    cfg = DetectorConfig(input_size=64, width_mult=0.25, depth_mult=0.33)
    _, v = yolo.init_params(cfg, jax.random.key(seed))
    flat = {k: np.asarray(x) for k, x in tu.flatten_dict(v).items()}
    dfl = np.full(16, -8.0, np.float32)
    dfl[1:3] = 4.0  # expected bin 1.5
    for k in list(flat):
        if k[0] == "params" and k[1] == "DetectHead_0" and k[2].startswith("Conv_"):
            box = int(k[2].split("_")[1]) % 2 == 0  # Conv_0 box, Conv_1 cls, ...
            if k[-1] == "kernel":
                flat[k] = np.zeros_like(flat[k])
            elif box:
                flat[k] = np.tile(dfl, 4)
            else:
                flat[k] = np.where(np.arange(flat[k].shape[0]) == 0, 3.0, -3.0).astype(np.float32)
    yolo.save_weights(tu.unflatten_dict(flat), path)
    return path
