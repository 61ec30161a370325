"""Device-resident keyframe descriptor database, a ring buffer
(counterpart of the JAX package's backend/keyframe_db.py).

One padded (N, F, 256) int8 tensor of descriptors plus a per-keyframe
bit-frequency histogram, the cheap place-recognition prefilter of loop
closure (backend/loop_closure.py): the histogram ranks every keyframe
at once and only the best candidates get the exact descriptor match.

The chunked evaluator's batch insert and the loop links are here;
`add_keyframe` and `covisible_slots` belong to the online loop closure
and wait for it (ROADMAP.md queue 1 item 10). Inserts write into the
preallocated buffers in place, where the reference donates them.
"""

from __future__ import annotations

import torch

from aria_slam_tpu_torch.config import LoopClosureConfig, OrbConfig
from aria_slam_tpu_torch.core.types import KeyframeDB


def descriptor_histogram(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(..., F, B) bits + (..., F) mask -> (..., B) mean bit frequency."""
    v = valid.float()
    n = torch.clamp(v.sum(-1, keepdim=True), min=1.0)
    return torch.sum(desc.float() * v[..., None], -2) / n


def init_db(cfg: LoopClosureConfig, orb: OrbConfig, device="cuda") -> KeyframeDB:
    n, f, b = cfg.max_keyframes, orb.num_features, orb.descriptor_bits
    return KeyframeDB(
        desc=torch.zeros((n, f, b), dtype=torch.int8, device=device),
        xy=torch.zeros((n, f, 2), dtype=torch.float32, device=device),
        desc_valid=torch.zeros((n, f), dtype=torch.bool, device=device),
        hist=torch.zeros((n, b), dtype=torch.float32, device=device),
        frame_id=torch.full((n,), -1, dtype=torch.int32, device=device),
        pose=torch.eye(4, dtype=torch.float32, device=device).repeat(n, 1, 1),
        covis=torch.zeros((n, n), dtype=torch.bool, device=device),
        size=torch.zeros((), dtype=torch.int32, device=device),
        head=torch.zeros((), dtype=torch.int32, device=device),
    )


def _covis_clear(covis: torch.Tensor, slots) -> torch.Tensor:
    """Ring eviction: an overwritten slot's old covisibility links are
    stale, so its row and column are zeroed (in place) before relinking."""
    covis[slots] = False
    covis[:, slots] = False
    return covis


def add_keyframes_batch(db: KeyframeDB, desc, xy, desc_valid, frame_ids,
                        poses) -> KeyframeDB:
    """Insert C keyframes at consecutive ring slots (head + k) % N in one
    call, with no read of the head on the host. desc (C, F, B) int8, xy
    (C, F, 2), desc_valid (C, F), frame_ids (C,), poses (C, 4, 4).
    Consecutive inserts are linked covisible (temporal adjacency),
    including the first new slot to the previously inserted keyframe.
    Writes into db's buffers and returns db with the new size and head."""
    c = desc.shape[0]
    cap = db.desc.shape[0]
    dev = db.desc.device
    slots = (db.head.long() + torch.arange(c, device=dev)) % cap
    covis = _covis_clear(db.covis, slots)
    # temporal chain: slot k-1 <-> slot k (the k = 0 predecessor is the
    # previous insert, masked out on the very first insert)
    pred = (slots - 1) % cap
    link_ok = torch.cat([(db.size > 0).reshape(1),
                         torch.ones(c - 1, dtype=torch.bool, device=dev)])
    covis[slots, pred] = covis[slots, pred] | link_ok
    covis[pred, slots] = covis[pred, slots] | link_ok
    db.desc.index_copy_(0, slots, desc)
    db.xy.index_copy_(0, slots, xy)
    db.desc_valid.index_copy_(0, slots, desc_valid)
    db.hist.index_copy_(0, slots, descriptor_histogram(desc, desc_valid))
    db.frame_id.index_copy_(0, slots, frame_ids.to(torch.int32))
    db.pose.index_copy_(0, slots, poses)
    return db.replace(covis=covis, size=torch.clamp(db.size + c, max=cap),
                      head=(db.head + c) % cap)


def mark_covisible(db: KeyframeDB, slot_a: int, slot_b: int) -> KeyframeDB:
    """Link two DB slots covisible (symmetric, in place): called for
    accepted loop-closure pairs, which observe the same scene."""
    db.covis[slot_a, slot_b] = True
    db.covis[slot_b, slot_a] = True
    return db
