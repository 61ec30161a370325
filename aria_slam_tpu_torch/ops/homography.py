"""Homography RANSAC + planar-degeneracy rescue for two-view VO
(counterpart of the JAX package's ops/homography.py).

When a dominant plane explains (nearly) the whole consensus, the
essential matrix's translation is arbitrary; the rescue takes the
motion from the homography's analytic decomposition instead, picking
the physical candidate by cheirality with a tie-break toward the
essential matrix's rotation. 4-point DLT hypotheses are batched 9x9
smallest-eigenvector problems, as the 8-point solves are.
"""

from __future__ import annotations

import torch

from aria_slam_tpu_torch.ops.epipolar import (
    _count_front, _homog, _pick, _rows, smallest_eigvec_9,
)
from aria_slam_tpu_torch.ops.linalg import det3, svd3


def _h_normal_matrix(p1, p2, w):
    """A^T W A for the DLT rows of ||x2 x (H x1)|| = 0 (batched)."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    zeros = torch.zeros_like(x1)
    r1 = torch.stack([-x1, -y1, -ones, zeros, zeros, zeros, x2 * x1, x2 * y1, x2], -1)
    r2 = torch.stack([zeros, zeros, zeros, -x1, -y1, -ones, y2 * x1, y2 * y1, y2], -1)
    A = torch.cat([r1 * w[..., None], r2 * w[..., None]], -2)  # (..., 2N, 9)
    Araw = torch.cat([r1, r2], -2)
    return A.transpose(-1, -2) @ Araw


def dlt_homography(p1, p2, w):
    """Weighted DLT estimate of H (normalized coords), batched."""
    return smallest_eigvec_9(_h_normal_matrix(p1, p2, w)).reshape(p1.shape[:-2] + (3, 3))


def transfer_error(H, p1, p2):
    """Squared forward transfer error |pi(H x1) - p2|^2 (..., N)."""
    Hx = _homog(p1) @ H.transpose(-1, -2)
    z = Hx[..., 2]
    zs = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    d = Hx[..., :2] / zs[..., None] - p2
    return torch.sum(d * d, -1)


def estimate_homography(p1, p2, valid, sampler, num_hypotheses: int,
                        thresh_sq, refine: bool = True):
    """RANSAC H from padded correspondences (..., N, 2) -> (H, inlier_mask,
    score), leading axes being independent pairs."""
    validf = valid.float()
    idx = sampler(valid, num_hypotheses, 4, "homography")  # (..., H, 4)
    ones = torch.ones(4, dtype=p1.dtype, device=p1.device)
    Hs = dlt_homography(_rows(p1, idx), _rows(p2, idx), ones)
    inl = ((transfer_error(Hs, p1[..., None, :, :], p2[..., None, :, :]) < thresh_sq).float()
           * validf[..., None, :])
    best = torch.argmax(inl.sum(-1), -1)
    H_best = _pick(Hs, best)
    mask = _pick(inl, best) > 0
    if refine:
        H_ref = dlt_homography(p1, p2, mask.to(p1.dtype))
        inl_ref = (transfer_error(H_ref, p1, p2) < thresh_sq) & valid
        better = inl_ref.sum(-1) >= mask.sum(-1)
        H_best = torch.where(better[..., None, None], H_ref, H_best)
        mask = torch.where(better[..., None], inl_ref, mask)
    return H_best, mask, mask.to(torch.int32).sum(-1)


def decompose_homography(H):
    """Faugeras-Lustman analytic decomposition of calibrated homographies
    (..., 3, 3) into 8 (R, t, n) candidates each -> (Rs (..., 8, 3, 3),
    ts (..., 8, 3), ns (..., 8, 3), strength (...,)), strength =
    (d1 - d3) / d2 ~ |t| / d."""
    U, S, Vt = svd3(H)
    V = Vt.transpose(-1, -2)
    s = det3(U) * det3(V)
    d1, d2, d3 = S[..., 0] / S[..., 1], 1.0, S[..., 2] / S[..., 1]
    kw = dict(dtype=H.dtype, device=H.device)

    eps = 1e-9
    denom = torch.clamp(d1 * d1 - d3 * d3, min=eps)
    aux1 = torch.sqrt(torch.clamp(d1 * d1 - d2 * d2, min=0.0) / denom)
    aux3 = torch.sqrt(torch.clamp(d2 * d2 - d3 * d3, min=0.0) / denom)
    e1 = torch.tensor([1.0, 1.0, -1.0, -1.0], **kw)
    e3 = torch.tensor([1.0, -1.0, 1.0, -1.0], **kw)
    x1 = e1 * aux1[..., None]   # (..., 4)
    x3 = e3 * aux3[..., None]
    zeros4 = torch.zeros_like(x1)
    ones4 = torch.ones_like(x1)
    cross_term = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3), min=0.0))

    # case d' = +d2
    st_aux = cross_term / torch.clamp((d1 + d3) * d2, min=eps)
    ct = (d2 * d2 + d1 * d3) / torch.clamp((d1 + d3) * d2, min=eps)
    st = e1 * e3 * st_aux[..., None]
    c4 = ct[..., None] * ones4
    Rp_pos = torch.stack([torch.stack([c4, zeros4, -st], -1),
                          torch.stack([zeros4, ones4, zeros4], -1),
                          torch.stack([st, zeros4, c4], -1)], -2)
    tp_pos = (d1 - d3)[..., None, None] * torch.stack([x1, zeros4, -x3], -1)

    # case d' = -d2 (mirror)
    sp_aux = cross_term / torch.clamp(torch.abs(d1 - d3) * d2, min=eps)
    cp = (d1 * d3 - d2 * d2) / torch.clamp(torch.abs(d1 - d3) * d2, min=eps)
    sp = e1 * e3 * sp_aux[..., None]
    c4n = cp[..., None] * ones4
    Rp_neg = torch.stack([torch.stack([c4n, zeros4, sp], -1),
                          torch.stack([zeros4, -ones4, zeros4], -1),
                          torch.stack([sp, zeros4, -c4n], -1)], -2)
    tp_neg = (d1 + d3)[..., None, None] * torch.stack([x1, zeros4, x3], -1)

    Rp = torch.cat([Rp_pos, Rp_neg], -3)
    tp = torch.cat([tp_pos, tp_neg], -2)
    npl = torch.stack([x1, zeros4, x3], -1)
    npl = torch.cat([npl, npl], -2)

    Rs = s[..., None, None, None] * torch.einsum("...ab,...kbc,...cd->...kad", U, Rp, Vt)
    ts = torch.einsum("...ab,...kb->...ka", U, tp)
    ns = torch.einsum("...ab,...kb->...ka", V, npl)
    return Rs, ts, ns, d1 - d3


def best_h_motion(H, R_hint, p1, p2, w):
    """The physical (R, t) among the 8 decompositions: most cheirality
    support, tie-broken toward the rotation hint -> (R, t_unit, strength)."""
    Rs, ts, _, strength = decompose_homography(H)
    tn = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True), min=1e-9)
    front = _count_front(Rs, tn, p1[..., None, :, :], p2[..., None, :, :], w[..., None, :])
    cos = 0.5 * (torch.diagonal(Rs @ R_hint[..., None, :, :].transpose(-1, -2),
                                dim1=-2, dim2=-1).sum(-1) - 1.0)
    k = torch.argmax(front + cos, -1)
    return _pick(Rs, k), _pick(tn, k), strength
