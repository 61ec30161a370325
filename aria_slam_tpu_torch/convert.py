"""Carry state over from the JAX package (the counterpart of carrying
weights; this path has no learned weights).

Turns the JAX package's `Features`, `PoseGraph` and VO `FrameState`,
given as numpy pytrees (each leaf already a numpy array, e.g. after
`jax.tree_util.tree_map(np.asarray, state)`), into the port's types on a
given device, so a port step can start from the exact carry a JAX step
produced. Fields are read by name; nothing of JAX is imported.
"""

from __future__ import annotations

import numpy as np
import torch

from aria_slam_tpu_torch.core.types import Features, PoseGraph
from aria_slam_tpu_torch.pipeline.slam_pipeline import FrameState


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def features_from_numpy(f, device) -> Features:
    return Features(**{name: _t(getattr(f, name), device) for name in
                       ("xy", "response", "angle", "octave", "size", "desc", "valid")})


def pose_graph_from_numpy(g, device) -> PoseGraph:
    return PoseGraph(**{name: _t(getattr(g, name), device)
                        for name in PoseGraph.__dataclass_fields__})


def frame_state_from_numpy(s, device) -> FrameState:
    """The VO subset of the JAX FrameState (EKF, keyframe DB, map and
    RANSAC key are not part of the port's carry)."""
    return FrameState(
        frame_id=int(np.asarray(s.frame_id)),
        prev_feats=features_from_numpy(s.prev_feats, device),
        prev_valid=_t(s.prev_valid, device),
        pose=_t(s.pose, device),
        prev_ts=_t(s.prev_ts, device),
        prev_depths=_t(s.prev_depths, device),
        prev_depth_mask=_t(s.prev_depth_mask, device),
        vo_scale=_t(s.vo_scale, device),
        graph=pose_graph_from_numpy(s.graph, device),
    )
