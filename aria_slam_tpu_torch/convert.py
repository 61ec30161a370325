"""Carry state over from the JAX package (the counterpart of carrying
weights; this path has no learned weights).

Turns the JAX package's `Features`, `PoseGraph` and VO `FrameState`,
given as numpy pytrees (each leaf already a numpy array, e.g. after
`jax.tree_util.tree_map(np.asarray, state)`), into the port's types on a
given device, so a port step can start from the exact carry a JAX step
produced. `chunked_state_from_numpy` does the same for the chunked
evaluator, from the arrays of the JAX `ChunkedSlam.snapshot` file.
Fields are read by name; nothing of JAX is imported.
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


def chunked_state_from_numpy(slam, state) -> None:
    """Start the port's `ChunkedSlam` `slam` from the JAX one's state
    after k chunks. `state` maps the names of the JAX
    `ChunkedSlam.snapshot` file to numpy arrays (an `np.load` of that
    file works): the pose graph as `graph.<field>`, the scale carry
    `zlast` / `mlast`, the running pose `T`, `counters` (frame_count,
    num_loops, ...), `scales` (_scale, _imu_corr, _vis_corr, _ba_corr,
    _vis_local), the trajectory `traj_ts` / `traj_T`, and, when the IMU
    scale estimator exists, its window as `est_*`. The keyframe DB, the
    map and the RANSAC key are not part of the port's state."""
    from aria_slam_tpu_torch.fusion.vi_init import ScaleEstimator

    dev = slam.device
    slam.graph = PoseGraph(**{name: _t(state[f"graph.{name}"], dev)
                              for name in PoseGraph.__dataclass_fields__})
    slam._zlast = _t(state["zlast"], dev)
    slam._mlast = _t(state["mlast"], dev)
    slam.T = np.array(state["T"], np.float32)
    slam.frame_count = int(state["counters"][0])
    slam.num_loops = int(state["counters"][1])
    (slam._scale, slam._imu_corr, slam._vis_corr, slam._ba_corr,
     slam._vis_local) = (float(x) for x in state["scales"][:5])
    slam.trajectory = [(float(t), np.array(T)) for t, T in
                       zip(state["traj_ts"], state["traj_T"])]
    slam._scale_est = None
    if "est_state" in state:
        est = ScaleEstimator(R_cam_imu=np.asarray(slam.cfg.imu_cam_rotation, np.float64),
                             device=dev)
        est._corr = float(state["est_state"][0])
        est._n_good = int(state["est_state"][1])
        est._last_p = np.array(state["est_last_p"]) if state["est_state"][2] > 0 else None
        est._ts = list(np.asarray(state["est_ts"]))
        est._inc = list(np.asarray(state["est_inc"]))
        est._tag = list(np.asarray(state["est_tag"]))
        est._Rwb = list(np.asarray(state["est_rwb"]))
        est._hist = [(float(a), float(b)) for a, b in np.asarray(state["est_hist"])]
        slam._scale_est = est
