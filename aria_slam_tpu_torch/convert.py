"""Carry state over from the JAX package (the counterpart of carrying
weights; this path has no learned weights).

Turns the JAX package's `Features`, `PoseGraph`, `MapState`, `EkfState`
and VO `FrameState`, given as numpy pytrees (each leaf already a numpy
array, e.g. after `jax.tree_util.tree_map(np.asarray, state)`), into the
port's types on a
given device, so a port step can start from the exact carry a JAX step
produced. `chunked_state_from_numpy` does the same for the chunked
evaluator (pose graph, keyframe DB, map, scale carry, trajectory), from
the arrays of the JAX `ChunkedSlam.snapshot` file, through the reader
of `ChunkedSlam.restore`. Fields are read by name; nothing of JAX is
imported.
"""

from __future__ import annotations

import numpy as np
import torch

from aria_slam_tpu_torch.core.types import EkfState, Features, MapState, PoseGraph
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


def map_state_from_numpy(m, device) -> MapState:
    return MapState(**{name: _t(getattr(m, name), device)
                       for name in MapState.__dataclass_fields__})


def ekf_state_from_numpy(s, device) -> EkfState:
    return EkfState(**{name: _t(getattr(s, name), device)
                       for name in EkfState.__dataclass_fields__})


def chunked_state_from_numpy(slam, state) -> None:
    """Start the port's `ChunkedSlam` `slam` from the state of a JAX one
    (or of a port one): `state` maps the key names of the
    `ChunkedSlam.snapshot` file to numpy arrays (an `np.load` of that file
    works). The same reader as `ChunkedSlam.restore`
    (`eval.chunked.load_state`), older layouts included."""
    from aria_slam_tpu_torch.eval.chunked import load_state

    load_state(slam, state)
