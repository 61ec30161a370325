"""PipelineFactory (counterpart of the JAX package's pipeline/factory.py;
ExecutionMode {GPU, CPU, MOCK}).

- create_gpu / create_cpu: the same pipeline on a CUDA or a CPU device.
- create_mock: injects a deterministic mock extractor so the whole
  orchestration can be driven without real features.
"""

from __future__ import annotations

import enum

import torch

from aria_slam_tpu_torch.config import PipelineConfig
from aria_slam_tpu_torch.core.types import Features
from aria_slam_tpu_torch.pipeline.slam_pipeline import SlamPipeline


class ExecutionMode(enum.Enum):
    GPU = "gpu"
    CPU = "cpu"
    MOCK = "mock"


def _mock_extractor(cfg: PipelineConfig):
    """Deterministic pseudo-features from image content: grid keypoints
    with descriptor bits hashed from the intensities under them."""
    k = cfg.orb.num_features
    bits = cfg.orb.descriptor_bits

    def extract(image: torch.Tensor) -> Features:
        h, w = image.shape
        dev = image.device
        side = int(k**0.5) + 1
        ys = torch.linspace(20, h - 20, side, device=dev)
        xs = torch.linspace(20, w - 20, side, device=dev)
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        xy = torch.stack([gx.reshape(-1), gy.reshape(-1)], -1)[:k].float()
        vals = image[xy[:, 1].long(), xy[:, 0].long()]
        seeds = (vals.double() * 2654435761.0).long() & 0xFFFFFFFF
        cols = torch.arange(bits, device=dev)
        desc = (((seeds[:, None] >> (cols[None, :] % 31)) ^ cols[None, :]) & 1).to(torch.int8)
        return Features(
            xy=xy,
            response=torch.ones((k,), device=dev),
            angle=torch.zeros((k,), device=dev),
            octave=torch.zeros((k,), dtype=torch.int32, device=dev),
            size=torch.full((k,), 31.0, device=dev),
            desc=desc,
            valid=torch.ones((k,), dtype=torch.bool, device=dev),
        )

    return extract


def create(mode: ExecutionMode | str = ExecutionMode.GPU,
           config: PipelineConfig | None = None, **kw) -> SlamPipeline:
    mode = ExecutionMode(mode) if isinstance(mode, str) else mode
    config = config or PipelineConfig()
    if mode is ExecutionMode.MOCK:
        return SlamPipeline(config, extractor=_mock_extractor(config), **kw)
    if mode is ExecutionMode.CPU:
        kw["device"] = "cpu"
    return SlamPipeline(config, **kw)


def create_gpu(config: PipelineConfig | None = None, **kw) -> SlamPipeline:
    return create(ExecutionMode.GPU, config, **kw)


def create_cpu(config: PipelineConfig | None = None, **kw) -> SlamPipeline:
    return create(ExecutionMode.CPU, config, **kw)


def create_mock(config: PipelineConfig | None = None, **kw) -> SlamPipeline:
    return create(ExecutionMode.MOCK, config, **kw)
