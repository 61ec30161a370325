"""The loop-closure keyframe DB split across the mesh's "model" ranks
(counterpart of the JAX package's parallel/sharded_db.py).

Each model rank holds its contiguous block of the keyframe axis, scores
the query (the same on every rank) against it in one match kernel launch
(ops/match.match_scores_vs_database) and keeps its own top-k; one
all_gather of the k values and indices (bytes, not megabytes) and a
second top-k give every rank the best keyframes of the whole DB. Both
top-k use jax.lax.top_k's order (ops/topk.top_k_stable): among equal
scores the lower global index wins, so a DB of duplicated keyframes
gives the same winners however it is split.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from aria_slam_tpu_torch.ops.match import match_scores_vs_database
from aria_slam_tpu_torch.ops.topk import top_k_stable
from aria_slam_tpu_torch.parallel.mesh import Mesh, make_mesh


def sharded_topk_scores(mesh: Mesh, desc_q: torch.Tensor, valid_q: torch.Tensor,
                        db_desc: torch.Tensor, db_valid: torch.Tensor, ratio: float = 0.7,
                        top_k: int = 5):
    """desc_q (F, B) int8 and valid_q (F,), the same on every rank;
    db_desc (N, F, B) int8 and db_valid (N, F), the whole DB, of which
    this rank scores its block of N / n_model keyframes. Returns (scores
    (top_k,), global indices (top_k,) int64) of the best keyframes of the
    whole DB, the same on every rank of the data row."""
    n_shards = mesh.shape["model"]
    n_total = db_desc.shape[0]
    if n_total % n_shards:
        raise ValueError(f"a DB of {n_total} keyframes does not split over {n_shards} model "
                         "ranks")
    shard_n = n_total // n_shards
    lo = mesh.index["model"] * shard_n
    scores = match_scores_vs_database(desc_q, valid_q, db_desc[lo:lo + shard_n],
                                      db_valid[lo:lo + shard_n], ratio)
    vals, idx = top_k_stable(scores, top_k)
    gidx = idx + lo
    if n_shards == 1:
        return vals, gidx
    all_vals = [torch.empty_like(vals) for _ in range(n_shards)]
    all_idx = [torch.empty_like(gidx) for _ in range(n_shards)]
    dist.all_gather(all_vals, vals.contiguous(), group=mesh.model_group)
    dist.all_gather(all_idx, gidx.contiguous(), group=mesh.model_group)
    best, pos = top_k_stable(torch.cat(all_vals), top_k)
    return best, torch.cat(all_idx)[pos]


def query_rank(rank: int, shapes, cases, ratio: float = 0.7, top_k: int = 5) -> list:
    """One rank of a spawned group (parallel/mesh.spawn): on a mesh of
    each (n_data, n_model) shape in turn, every case (desc_q, valid_q,
    db_desc, db_valid), numpy arrays, through sharded_topk_scores on
    mesh.device. Returns [[(scores, indices) a case] a shape] as numpy."""
    out = []
    for n_data, n_model in shapes:
        mesh = make_mesh(n_data, n_model)
        res = []
        for case in cases:
            vals, idx = sharded_topk_scores(
                mesh, *(torch.from_numpy(x).to(mesh.device) for x in case), ratio=ratio,
                top_k=top_k)
            res.append((vals.cpu().numpy(), idx.cpu().numpy()))
        out.append(res)
    return out
