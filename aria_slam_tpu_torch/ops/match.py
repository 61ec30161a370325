"""Brute-force Hamming matching + Lowe ratio test (counterpart of the JAX
package's ops/match.py).

Every kNN-2 goes through the match kernel (ops/cuda/match_kernel.py),
except the cross-checked form, which needs the whole distance matrix
and builds it with `hamming_matrix`, as the reference does. Loop
closure's candidate scores and verify matches use the kernel too
(backend/loop_closure.py).
`match_scores_vs_database` serves the sharded keyframe DB and waits for
parallel/sharded_db.py (ROADMAP.md queue 1 item 12).
"""

from __future__ import annotations

import torch

from aria_slam_tpu_torch.core.types import Features, Matches
from aria_slam_tpu_torch.ops.cuda.match_kernel import (  # noqa: F401 (public names)
    BIG, hamming_matrix, match_top2, match_top2_batched, top2_min,
)


def ratio_gate(query_valid, best, second, ratio: float):
    """The Lowe ratio test over kNN-2 outputs."""
    return query_valid & (best.float() < ratio * second.float()) & (best < BIG)


def match(query: Features, train: Features, ratio: float = 0.75,
          cross_check: bool = False) -> Matches:
    """kNN(k=2) + ratio test over padded feature sets."""
    kq = query.desc.shape[0]
    if cross_check:
        dist = hamming_matrix(query.desc, train.desc, train.valid)
        best, second, best_idx = top2_min(dist)
    else:
        best, second, best_idx = match_top2(query.desc, train.desc, train.valid)
    ok = ratio_gate(query.valid, best, second, ratio)
    if cross_check:
        # the train point's best query must be this query (mutual nearest)
        _, _, train_best_q = top2_min(
            torch.where(query.valid[:, None], dist, BIG), dim=0)
        mutual = train_best_q[best_idx.long()] == torch.arange(kq, device=dist.device)
        ok = ok & mutual
    return Matches(
        query_idx=torch.arange(kq, dtype=torch.int32, device=query.desc.device),
        train_idx=best_idx.to(torch.int32),
        distance=best.float(),
        valid=ok,
    )


def match_batched_raw(query: Features, train: Features):
    """Batched kNN-2 without the ratio gate: (best, second, best_idx),
    each (C, Kq), so one Hamming pass can serve several gates."""
    return match_top2_batched(query.desc, train.desc, train.valid)


def match_batched(query: Features, train: Features, ratio: float = 0.75) -> Matches:
    """kNN-2 + ratio test over Features with a leading pair axis."""
    best, second, best_idx = match_batched_raw(query, train)
    n, kq = best.shape
    qidx = torch.arange(kq, dtype=torch.int32, device=best.device).expand(n, kq)
    return Matches(query_idx=qidx, train_idx=best_idx.to(torch.int32),
                   distance=best.float(),
                   valid=ratio_gate(query.valid, best, second, ratio))
