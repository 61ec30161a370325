"""Ports: the dependency-injection seams of the pipeline (counterpart of
the JAX package's pipeline/interfaces.py).

Parity: the reference's pure-virtual interfaces (include/interfaces/
*.hpp: IFeatureExtractor, IMatcher, ILoopDetector, IObjectDetector,
ISensorFusion, IMapper). Here they are Protocols over functions on torch
tensors: anything with the signature can be injected into the frame step
(SlamPipeline(extractor=, matcher=, detector=, sampler=)), the real
kernels, their plain versions or mocks. RANSAC's randomness enters
through a sampler (ops/epipolar.py), where the JAX package passes a key.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import torch

from aria_slam_tpu_torch.core.types import Detections, EkfState, Features, MapState, Matches


@runtime_checkable
class FeatureExtractor(Protocol):
    """Parity: IFeatureExtractor."""

    def __call__(self, image: torch.Tensor) -> Features: ...


@runtime_checkable
class Matcher(Protocol):
    """Parity: IMatcher."""

    def __call__(self, query: Features, train: Features) -> Matches: ...


@runtime_checkable
class ObjectDetector(Protocol):
    """Parity: IObjectDetector (models/detect.make_detector)."""

    def __call__(self, image: torch.Tensor) -> Detections: ...


@runtime_checkable
class Sampler(Protocol):
    """RANSAC's minimal samples: (valid (..., K), hypotheses, sample size,
    stage) -> (..., hypotheses, sample size) int64 indices of valid slots."""

    def __call__(self, valid: torch.Tensor, num_hypotheses: int, sample_size: int,
                 stage: str) -> torch.Tensor: ...


@runtime_checkable
class PoseEstimator(Protocol):
    """The epipolar VO stage (the reference keeps it inline in the app
    loop, src/main.cpp:179-201)."""

    def __call__(self, xy1, xy2, valid, sampler) -> "PoseDelta": ...  # noqa: F821


@runtime_checkable
class LoopDetector(Protocol):
    """Parity: ILoopDetector."""

    def __call__(self, db, feats: Features, frame_id, sampler) -> "LoopResult": ...  # noqa: F821


@runtime_checkable
class SensorFusion(Protocol):
    """Parity: ISensorFusion (predictIMU / updateVO folded into one
    frame_step over a padded IMU window and the VO measurement)."""

    def __call__(self, state: EkfState, imu_t, imu_accel, imu_gyro,
                 imu_valid, R_vo, t_vo, vo_valid, frame_t) -> EkfState: ...


@runtime_checkable
class Mapper(Protocol):
    """Parity: IMapper (triangulate into the padded map buffer)."""

    def __call__(self, map_state: MapState, K, T1_cw, T2_cw,
                 uv1, uv2, valid, image) -> MapState: ...
