"""Domain tensor types (counterpart of the JAX package's core/types.py).

Capacity-padded fixed-shape tensors with validity masks, exactly as the
JAX package lays them out, so the tests compare like with like and
convert.py can carry a JAX carry over field for field.
"""

from __future__ import annotations

import dataclasses

import torch


class _TensorTree:
    """Dataclass helpers shared by the types below: functional `replace`
    and a per-leaf `map` (the counterpart of jax.tree_util.tree_map)."""

    def replace(self, **changes):
        return dataclasses.replace(self, **changes)

    def map(self, fn):
        return type(self)(**{
            f.name: (getattr(self, f.name).map(fn)
                     if isinstance(getattr(self, f.name), _TensorTree)
                     else fn(getattr(self, f.name)))
            for f in dataclasses.fields(self)
        })


@dataclasses.dataclass
class Features(_TensorTree):
    """One frame's ORB features, padded to `num_features` (leading batch
    axes allowed)."""

    xy: torch.Tensor        # (K, 2) float32, level-0 pixel coords
    response: torch.Tensor  # (K,) float32 Harris response used for ranking
    angle: torch.Tensor     # (K,) float32 orientation, radians
    octave: torch.Tensor    # (K,) int32 pyramid level
    size: torch.Tensor      # (K,) float32 patch diameter at level-0 scale
    desc: torch.Tensor      # (K, 256) int8 in {0, 1}
    valid: torch.Tensor     # (K,) bool

    @property
    def capacity(self) -> int:
        return self.xy.shape[-2]

    def num_valid(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(-1)


@dataclasses.dataclass
class Matches(_TensorTree):
    """Per-query match result, padded to the query capacity."""

    query_idx: torch.Tensor  # (K,) int32
    train_idx: torch.Tensor  # (K,) int32 best match in the train frame
    distance: torch.Tensor   # (K,) float32 Hamming distance of the best
    valid: torch.Tensor      # (K,) bool: passed the ratio test, both valid

    def num_valid(self) -> torch.Tensor:
        return self.valid.to(torch.int32).sum(-1)


@dataclasses.dataclass
class PoseDelta(_TensorTree):
    """Relative camera motion: x2 = R @ x1 + t, |t| = 1."""

    R: torch.Tensor            # (3, 3)
    t: torch.Tensor            # (3,) unit norm
    num_inliers: torch.Tensor  # () int32
    inlier_mask: torch.Tensor  # (K,) bool over the match slots
    success: torch.Tensor      # () bool


@dataclasses.dataclass
class Detections(_TensorTree):
    """Object-detector output, padded to max_detections (leading batch
    axes allowed). Boxes are (x1, y1, x2, y2) in input-image pixels."""

    boxes: torch.Tensor    # (D, 4) float32
    scores: torch.Tensor   # (D,) float32
    classes: torch.Tensor  # (D,) int32
    valid: torch.Tensor    # (D,) bool


@dataclasses.dataclass
class PoseGraph(_TensorTree):
    """SE3 pose graph padded to static capacities (node 0 fixed)."""

    node_pose: torch.Tensor    # (N, 4, 4) float32 world-from-camera
    node_valid: torch.Tensor   # (N,) bool
    edge_i: torch.Tensor       # (E,) int32
    edge_j: torch.Tensor       # (E,) int32
    edge_rel: torch.Tensor     # (E, 4, 4) float32 measured T_i^-1 T_j
    edge_weight: torch.Tensor  # (E,) float32
    edge_twt: torch.Tensor     # (E,) float32 translation weight in [0, 1]
    edge_rwt: torch.Tensor     # (E,) float32 rotation weight (>= 0)
    edge_valid: torch.Tensor   # (E,) bool
    num_nodes: torch.Tensor    # () int32
    num_edges: torch.Tensor    # () int32


@dataclasses.dataclass
class KeyframeDB(_TensorTree):
    """Device-resident keyframe descriptor ring, padded to `max_keyframes`
    slots (backend/keyframe_db.py)."""

    desc: torch.Tensor        # (N, F, 256) int8 bits
    xy: torch.Tensor          # (N, F, 2) float32 keypoint coords
    desc_valid: torch.Tensor  # (N, F) bool
    hist: torch.Tensor        # (N, 256) float32 mean bit frequencies (prefilter)
    frame_id: torch.Tensor    # (N,) int32 source frame index (-1 = empty)
    pose: torch.Tensor        # (N, 4, 4) float32 world-from-camera at insert
    covis: torch.Tensor       # (N, N) bool covisibility between slots
    size: torch.Tensor        # () int32 occupied slots
    head: torch.Tensor        # () int32 next slot to write


@dataclasses.dataclass
class MapState(_TensorTree):
    """Sparse 3D map padded to `max_points` (mapping/mapper.py)."""

    points: torch.Tensor   # (P, 3) float32 world coordinates
    colors: torch.Tensor   # (P, 3) float32 in [0, 1]
    quality: torch.Tensor  # (P,) float32
    valid: torch.Tensor    # (P,) bool
    count: torch.Tensor    # () int32 insertion cursor


@dataclasses.dataclass
class EkfState(_TensorTree):
    """15-state error-state EKF (fusion/ekf.py). P is the error covariance
    over [dp(3), dv(3), dtheta(3), dba(3), dbg(3)]."""

    pos: torch.Tensor          # (3,)
    vel: torch.Tensor          # (3,)
    quat: torch.Tensor         # (4,) (w, x, y, z)
    ba: torch.Tensor           # (3,) accel bias
    bg: torch.Tensor           # (3,) gyro bias
    P: torch.Tensor            # (15, 15)
    last_imu_t: torch.Tensor   # () float32 seconds from the sequence start
    initialized: torch.Tensor  # () bool


def make_empty_features(capacity: int, bits: int = 256,
                        device="cuda") -> Features:
    return Features(
        xy=torch.zeros((capacity, 2), dtype=torch.float32, device=device),
        response=torch.zeros((capacity,), dtype=torch.float32, device=device),
        angle=torch.zeros((capacity,), dtype=torch.float32, device=device),
        octave=torch.zeros((capacity,), dtype=torch.int32, device=device),
        size=torch.full((capacity,), 31.0, dtype=torch.float32, device=device),
        desc=torch.zeros((capacity, bits), dtype=torch.int8, device=device),
        valid=torch.zeros((capacity,), dtype=torch.bool, device=device),
    )
