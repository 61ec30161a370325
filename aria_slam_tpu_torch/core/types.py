"""Domain tensor types (counterpart of the JAX package's core/types.py).

Capacity-padded fixed-shape tensors with validity masks, exactly as the
JAX package lays them out, so the tests compare like with like and
convert.py can carry a JAX carry over field for field. `EkfState`,
`Detections`, `KeyframeDB` and `MapState` belong to features the port
does not run yet (see ROADMAP.md queue 1).
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
