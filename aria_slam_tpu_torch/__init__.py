"""aria_slam_tpu_torch: the PyTorch/CUDA port of aria_slam_tpu.

A second package beside the JAX one, for one NVIDIA H100. Plain tensor
code is PyTorch; each Pallas kernel of the JAX package is a CUDA C++
kernel for sm_90a under csrc/ (built with nvcc at first use), with a
plain PyTorch version beside it that CPU tensors take. Entry points run
on CUDA unless the caller passes device="cpu".

Ported so far: the online VO-only per-frame pipeline
(pipeline.slam_pipeline.SlamPipeline with fusion, loop closure,
mapping and detection off) and every module it runs. The rest of the
JAX package is listed in ROADMAP.md.

TF32 is never enabled here: geometry matmuls run in full float32, and
no convolution is used (cuDNN's float32 convolutions default to TF32).
"""

__version__ = "0.1.0"

from aria_slam_tpu_torch.config import (  # noqa: F401
    CameraConfig,
    MatcherConfig,
    OrbConfig,
    PipelineConfig,
    PoseGraphConfig,
    RansacConfig,
)
