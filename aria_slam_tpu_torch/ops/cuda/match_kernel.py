"""Brute-force Hamming kNN-2 (counterpart of the JAX package's
ops/pallas/match_kernel.py).

`match_top2_batched` launches csrc/match_kernel.cu for CUDA tensors and
runs `match_top2_plain` for CPU tensors. The plain version is the
reference formulation itself: the Hamming matrix as a float32 product of
the 0/1 bits (exact: every sum is an integer <= 256) and the packed
(distance << 20 | index) min-reductions that fix the tie and sentinel
rules.
"""

from __future__ import annotations

import torch

from aria_slam_tpu_torch.ops.cuda import _lib

BIG = 1 << 20
_CLIP = 1 << 10   # > max Hamming (256); marks invalid entries
_IDX_BITS = 20    # supports up to 2^20 train columns


def hamming_matrix(desc_q: torch.Tensor, desc_t: torch.Tensor,
                   valid_t: torch.Tensor | None = None) -> torch.Tensor:
    """(..., Kq, B) x (..., Kt, B) {0,1} int8 -> (..., Kq, Kt) int32
    Hamming distances; invalid train columns get BIG."""
    dots = (desc_q.float() @ desc_t.float().transpose(-1, -2)).to(torch.int32)
    pop_q = desc_q.to(torch.int32).sum(-1)
    pop_t = desc_t.to(torch.int32).sum(-1)
    dist = pop_q[..., :, None] + pop_t[..., None, :] - 2 * dots
    if valid_t is not None:
        dist = torch.where(valid_t[..., None, :], dist, BIG)
    return dist


def top2_min(dist: torch.Tensor, dim: int = -1):
    """Two smallest values + index of the smallest along `dim`, as packed
    (value << 20 | index) min-reductions: ties go to the lowest index and
    any entry >= 1024 reports as BIG."""
    dim = dim % dist.dim()
    n = dist.shape[dim]
    if n >= (1 << _IDX_BITS):
        raise ValueError(f"top2_min supports < 2^20 entries, got {n}")
    shape = [1] * dist.dim()
    shape[dim] = n
    cols = torch.arange(n, dtype=torch.int32, device=dist.device).reshape(shape)
    clipped = torch.clamp(dist, max=_CLIP)
    packed = (clipped << _IDX_BITS) | cols
    m1 = packed.amin(dim)
    best_idx = m1 & ((1 << _IDX_BITS) - 1)
    best_c = m1 >> _IDX_BITS
    mask = cols == best_idx.unsqueeze(dim)
    m2 = torch.where(mask, 0x7FFFFFFF, packed).amin(dim)
    second_c = m2 >> _IDX_BITS
    best = torch.where(best_c >= _CLIP, BIG, best_c)
    second = torch.where(second_c >= _CLIP, BIG, second_c)
    return best, second, best_idx


def match_top2_plain(desc_q: torch.Tensor, desc_t: torch.Tensor,
                     valid_t: torch.Tensor):
    """Plain PyTorch version of the kernel."""
    return top2_min(hamming_matrix(desc_q, desc_t, valid_t))


def match_top2_batched(desc_q: torch.Tensor, desc_t: torch.Tensor,
                       valid_t: torch.Tensor):
    """(N, Kq, 256), (N, Kt, 256) {0,1} int8 + (N, Kt) bool ->
    (best, second, best_idx), each (N, Kq) int32."""
    if desc_q.device.type == "cpu":
        return match_top2_plain(desc_q, desc_t, valid_t)
    n, kq, bits = desc_q.shape
    if bits != 256:
        raise ValueError(f"the match kernel takes 256-bit descriptors, got {bits}")
    _lib.require_cuda(desc_q, "desc_q", torch.int8, (n, kq, 256))
    _lib.require_cuda(desc_t, "desc_t", torch.int8, (n, None, 256))
    kt = desc_t.shape[1]
    _lib.require_cuda(valid_t, "valid_t", torch.bool, (n, kt))
    if not desc_q.device == desc_t.device == valid_t.device:
        raise ValueError("all inputs must lie on the same device")
    if kt < 1:
        raise ValueError("the train set must hold at least one descriptor")
    if desc_q.data_ptr() % 16 or desc_t.data_ptr() % 16:
        raise ValueError("descriptor tensors must be 16-byte aligned")
    outs = [torch.empty((n, kq), dtype=torch.int32, device=desc_q.device)
            for _ in range(3)]
    if kq == 0:
        return tuple(outs)
    code = _lib.library("match").match_top2_launch(
        desc_q.data_ptr(), desc_t.data_ptr(), valid_t.data_ptr(),
        *(o.data_ptr() for o in outs), n, kq, kt, _lib.stream_ptr(desc_q.device))
    _lib.check_launch(code, "match")
    match_top2_batched.launches += 1
    return tuple(outs)


match_top2_batched.launches = 0


def match_top2(desc_q: torch.Tensor, desc_t: torch.Tensor, valid_t: torch.Tensor):
    """(Kq, 256), (Kt, 256) single-pair wrapper."""
    b, s, i = match_top2_batched(desc_q[None], desc_t[None], valid_t[None])
    return b[0], s[0], i[0]
