"""The precision the reference computes in. "fp32": float32 with TF32 off
for matmuls and cuDNN (what the configurations state for the geometry);
"tf32": TF32 on, the next precision below float32 (the control). The
detector's control runs its convolutions on fp8 (e4m3) operands with a
per-tensor scale, the next precision below its bf16."""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def mode(name: str):
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    tf32 = name == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8(t: torch.Tensor) -> torch.Tensor:
    """t rounded to float8 e4m3 after scaling its largest |value| to 448."""
    s = t.abs().amax().clamp(min=1e-12) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(t.dtype) * s
