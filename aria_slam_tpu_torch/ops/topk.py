"""Top-k in jax.lax.top_k's order, shared by the loop-closure prefilter
(backend/loop_closure.py) and the detector's postprocess
(models/detect.py)."""

from __future__ import annotations

import torch


def top_k_stable(x: torch.Tensor, k: int):
    """(values, indices) of the k largest entries along the last axis,
    the lower index first among equal values (jax.lax.top_k's order;
    torch.topk promises none)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]
