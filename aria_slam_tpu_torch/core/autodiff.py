"""Jacobians of row-separable functions (the port's counterpart of the
reference's jax.jacfwd uses).

The pose-graph residuals and the Sampson polish residuals are
row-separable: output row n depends only on input row n (one edge, one
correspondence). So the Jacobian rows come out of ONE reverse-mode pass:
give each of the M outputs of a row its own copy of the row's input,
sum output k of copy k over everything, and differentiate once. Exact
autodiff of the same implementation the reference differentiates;
forward-mode AD (torch.func.jacfwd, torch.autograd.forward_ad) would be
the literal translation, but on torch 2.13 it runs every op that mixes
a dual and a plain tensor through a slow Python path.
"""

from __future__ import annotations

import torch


def row_jacobian(fn, x: torch.Tensor, out_dim: int) -> torch.Tensor:
    """Jacobian (..., out_dim, D) of fn at x (..., D), where fn maps
    (..., C, D) to (..., C, out_dim) row by row (C = copies)."""
    shape = x.shape[:-1] + (out_dim, x.shape[-1])
    xr = x.detach()[..., None, :].expand(shape).clone().requires_grad_(True)
    with torch.enable_grad():
        out = fn(xr)  # (..., out_dim copies, out_dim outputs)
        total = torch.diagonal(out, dim1=-2, dim2=-1).sum()
        (grad,) = torch.autograd.grad(total, xr)
    return grad
