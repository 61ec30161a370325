"""Brute-force Hamming matching + Lowe ratio test (counterpart of the JAX
package's ops/match.py).

Every kNN-2 goes through the match kernel (ops/cuda/match_kernel.py),
except the cross-checked form, which needs the whole distance matrix
and builds it with `hamming_matrix`, as the reference does. Loop
closure's candidate scores and verify matches use the kernel too
(backend/loop_closure.py), and so does `match_scores_vs_database`, the
one-query-against-the-whole-DB scores of the sharded keyframe DB
(parallel/sharded_db.py).
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


def match_scores_vs_database(desc_q: torch.Tensor, valid_q: torch.Tensor,
                             db_desc: torch.Tensor, db_valid: torch.Tensor,
                             ratio: float = 0.7) -> torch.Tensor:
    """Place-recognition scores of one query frame against every keyframe
    of a DB in one match kernel launch: desc_q (F, B) int8, valid_q (F,),
    db_desc (N, F_t, B) int8, db_valid (N, F_t) -> (N,) float32, each the
    number of the query's ratio-test survivors against that keyframe over
    the number of valid queries. The query is repeated for each keyframe
    (the kernel takes contiguous inputs): a copy of N * F * B bytes, 262
    MB at N = 512 and F = 2000."""
    n = db_desc.shape[0]
    q = desc_q.expand(n, *desc_q.shape).contiguous()
    best, second, _ = match_top2_batched(q, db_desc, db_valid)
    del q
    good = ratio_gate(valid_q[None], best, second, ratio)
    num_q = torch.clamp(valid_q.float().sum(), min=1.0)
    return good.float().sum(1) / num_q
