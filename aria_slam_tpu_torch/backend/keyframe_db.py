"""Keyframe descriptor statistics (counterpart of the JAX package's
backend/keyframe_db.py).

Only the bit-frequency histogram is here: the chunked front end returns
one per frame for the place-recognition prefilter. The keyframe ring
buffer itself comes with loop closure (ROADMAP.md queue 1 item 6).
"""

from __future__ import annotations

import torch


def descriptor_histogram(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., F, B) bits + (..., F) mask -> (..., B) mean bit frequency."""
    v = valid.float()
    n = torch.clamp(v.sum(-1, keepdim=True), min=1.0)
    return torch.sum(desc.float() * v[..., None], -2) / n
