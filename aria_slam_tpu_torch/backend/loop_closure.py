"""Loop closure: histogram-prefiltered place recognition and batched
geometric verification (counterpart of the JAX package's
backend/loop_closure.py).

A bit-frequency histogram ranks every keyframe of the DB at once
(`batch_candidates`); the best PREFILTER_K candidates of each query get
the exact ratio-test match score (`_full_scores`, one match kernel
launch for all queries' candidates), and the best-scoring (query,
candidate) pairs are verified together (`verify_candidate`): every
function takes a leading axis of verify pairs, and the pairs' kNN-2 is
one launch of the match kernel, so no (pairs, Kq, Kt) distance tensor is
built on the card. The chunked evaluator verifies a chunk's best pairs
(eval/chunked.py); the online step's `detect` verifies one frame's
top_k_candidates, without the rotation-only rescue, and keeps the first
that passes.

RANSAC draws through the sampler argument, as in ops/epipolar.py.
"""

from __future__ import annotations

import dataclasses

import torch

from aria_slam_tpu_torch.backend.keyframe_db import descriptor_histogram
from aria_slam_tpu_torch.config import LoopClosureConfig, RansacConfig
from aria_slam_tpu_torch.core import lie
from aria_slam_tpu_torch.core.types import Features, KeyframeDB, _TensorTree
from aria_slam_tpu_torch.ops import epipolar
from aria_slam_tpu_torch.ops.match import BIG, match_top2_batched, ratio_gate
from aria_slam_tpu_torch.ops.topk import top_k_stable
from aria_slam_tpu_torch.utils.profiling import count

PREFILTER_K = 8  # candidates promoted from the histogram ranking to full matching


@dataclasses.dataclass
class LoopResult(_TensorTree):
    detected: torch.Tensor     # () bool
    slot: torch.Tensor         # () int32 DB slot of the matched keyframe
    frame_id: torch.Tensor     # () int32 frame id of the matched keyframe
    score: torch.Tensor        # () float32 place-recognition score
    num_inliers: torch.Tensor  # () int32
    T_rel: torch.Tensor        # (4, 4) candidate-cam-from-current-cam motion
    t_weight: torch.Tensor     # () float32 in [0, 1]: parallax confidence of T_rel's t


def no_loop(device) -> LoopResult:
    """The LoopResult of a frame without a loop."""
    return LoopResult(
        detected=torch.tensor(False, device=device),
        slot=torch.tensor(-1, dtype=torch.int32, device=device),
        frame_id=torch.tensor(-1, dtype=torch.int32, device=device),
        score=torch.tensor(0.0, device=device),
        num_inliers=torch.tensor(0, dtype=torch.int32, device=device),
        T_rel=torch.eye(4, device=device),
        t_weight=torch.tensor(0.0, device=device))


def _gated_candidates(db: KeyframeDB, hist_q, frame_id, cfg: LoopClosureConfig, k: int):
    """Histogram-similarity ranking with the gap and occupancy gates:
    hist_q (..., B), frame_id (...) -> (sims (..., k), slots (..., k))."""
    # L1 similarity of bit-frequency histograms (BoW-style scoring)
    l1 = torch.sum(torch.abs(db.hist - hist_q[..., None, :]), -1)  # (..., N)
    sim = 1.0 - l1 / 256.0
    occupied = db.frame_id >= 0
    gap_ok = (frame_id[..., None] - db.frame_id) >= cfg.min_frames_between
    return top_k_stable(torch.where(occupied & gap_ok, sim, -1.0), k)


def batch_candidates(db: KeyframeDB, hists, frame_ids, cfg: LoopClosureConfig):
    """Histogram prefilter for a chunk of frames at once: hists (C, B),
    frame_ids (C,) -> (sims (C, k), slots (C, k))."""
    return _gated_candidates(db, hists, frame_ids, cfg, PREFILTER_K)


def _full_scores(db: KeyframeDB, desc, valid, slots, ratio: float) -> torch.Tensor:
    """Exact ratio-test match scores of C queries against their k
    candidate slots each, in ONE match kernel launch over the C x k
    pairs: each query's descriptors repeated for its candidates (the
    kernel takes contiguous inputs, so the repeat is a copy: 4 MB a query
    at k = 8, F = 2000), the candidates' gathered from the DB. desc (C, F,
    B), valid (C, F), slots (C, k) -> (C, k) matches / valid queries."""
    c, k = slots.shape
    flat = slots.reshape(-1)
    q = torch.repeat_interleave(desc, k, dim=0)  # (C k, F, B)
    best, second, _ = match_top2_batched(q, db.desc[flat], db.desc_valid[flat])
    del q
    good = ratio_gate(torch.repeat_interleave(valid, k, dim=0), best, second, ratio)
    num_q = torch.clamp(valid.float().sum(1), min=1.0)
    return good.float().sum(1).reshape(c, k) / num_q[:, None]


def score_candidates(db: KeyframeDB, feats: Features, slots, cfg: LoopClosureConfig):
    """Exact match scores of one query frame against its candidate slots (k,)."""
    return _full_scores(db, feats.desc[None], feats.valid[None], slots[None], cfg.ratio)[0]


def _match_against_slot(feats: Features, db: KeyframeDB, slot, ratio: float,
                        loose_ratio: float | None = None):
    """Ratio-test matches of each query (V, F) against its DB keyframe
    slot (V,), one match kernel launch for all V pairs. Returns aligned
    (xy_q, xy_t, valid[, valid_loose]); the loose tier shares the same
    kNN-2 (one Hamming pass, two gates)."""
    best_i, second_i, best_idx = match_top2_batched(feats.desc, db.desc[slot],
                                                    db.desc_valid[slot])
    best, second = best_i.float(), second_i.float()
    finite = feats.valid & (best < float(BIG))
    ok = finite & (best < ratio * second)
    xy_t = torch.take_along_dim(db.xy[slot], best_idx.long()[..., None], -2)
    if loose_ratio is None:
        return feats.xy, xy_t, ok
    return feats.xy, xy_t, ok, finite & (best < loose_ratio * second)


def _guided_rematch(delta, xy_q, xy_t, ok_loose, K, cfg: LoopClosureConfig):
    """Pose-guided re-match: re-admit loose-ratio matches consistent with
    the verified epipolar geometry, re-polish (R, t) on the bigger
    consensus and keep it where it did not lose inliers. A pair whose
    RANSAC failed keeps its delta."""
    p1 = epipolar.normalize_points(xy_q, K)
    p2 = epipolar.normalize_points(xy_t, K)
    focal = 0.5 * (K[0, 0] + K[1, 1])
    thresh_sq = (cfg.verify_threshold_px / focal) ** 2
    s = epipolar.sampson_error(epipolar.lax_skew_E(delta.R, delta.t), p1, p2)
    cand = (ok_loose & (s < thresh_sq)) | delta.inlier_mask
    R2, t2 = epipolar.polish_pose_sampson(delta.R, delta.t, p1, p2, cand.to(p1.dtype),
                                          thresh_sq, iters=4)
    errs2 = epipolar.sampson_error(epipolar.lax_skew_E(R2, t2), p1, p2)
    mask2 = (errs2 < thresh_sq) & ok_loose
    n2 = mask2.to(torch.int32).sum(-1)
    use = delta.success & (n2 >= delta.num_inliers)
    return delta.replace(
        R=torch.where(use[..., None, None], R2, delta.R),
        t=torch.where(use[..., None], t2, delta.t),
        inlier_mask=torch.where(use[..., None], mask2, delta.inlier_mask),
        num_inliers=torch.where(use, n2, delta.num_inliers),
    )


def _loop_scale(delta, xy_q, xy_t, ok, K, scale_mode: str, scene_depth: float,
                depths, depth_mask, depth_scale, scale_corr=1.0):
    """Metric scale of the loop edges' translations (leading pair axis).

    With the odometry's unit depths of the query frame (depths,
    depth_mask) and its running scale (depth_scale), the loop pair's own
    depths are ratioed against the chain's at the same keypoint slots,
    so the edge lands in the odometry's local metric; with too few shared
    slots, the ratio of the two sides' geometric-mean depths (right at
    any baseline: |t| -> 0 at a zero-baseline revisit); else the
    scene-depth pin, times scale_corr (the IMU correction). "unit":
    |t| = 1."""
    if scale_mode == "unit":
        return delta.t
    z1, _, good = epipolar.pair_depths(delta, xy_q, xy_t, ok, K)
    pin, _ = epipolar.pin_scale(z1, good, scene_depth)
    pin = pin * scale_corr
    if depths is not None:
        ratio, cnt = epipolar.geomean_ratio(depths, z1, good & depth_mask)
        ones = torch.ones_like(z1)
        g_chain, c_chain = epipolar.geomean_ratio(depths, ones, depth_mask)
        g_loop, c_loop = epipolar.geomean_ratio(z1, ones, good)
        s_mm = depth_scale * g_chain / torch.clamp(g_loop, min=1e-4)
        ok_mm = (c_chain >= 20) & (c_loop >= 20)
        s = torch.where(cnt >= 10, depth_scale * ratio, torch.where(ok_mm, s_mm, pin))
    else:
        s = pin
    return delta.t * torch.clamp(s, 0.01, 100.0)[..., None]


def verify_candidate(db: KeyframeDB, feats: Features, slot, K, cfg: LoopClosureConfig,
                     ransac: RansacConfig, sampler, scale_mode: str = "unit",
                     scene_depth: float = 4.0, depths=None, depth_mask=None,
                     depth_scale=None, scale_corr=1.0, rot_only_rescue: bool = True):
    """Geometric verification of V (query, DB slot) pairs at once:
    feats with a leading axis V, slot (V,) -> (passed (V,), num_inliers
    (V,), T_rel (V, 4, 4), t_weight (V,)), T_rel = T_matched_from_current.
    depths / depth_mask (V, F) and depth_scale (V,): each query frame's
    odometry unit depths and running metric scale (see _loop_scale).
    rot_only_rescue: the chunked evaluator's RANSAC lets a revisit at the
    same pose (zero baseline) pass cheirality on its rotation alone; the
    online detect's does not."""
    guided = cfg.guided_ratio > 0
    # with guided re-matching the RANSAC verifies geometry on a reduced
    # strict-inlier bar and the full min_matches bar applies to the
    # boosted count
    ransac_bar = (max(8, int(cfg.min_matches * cfg.guided_min_frac))
                  if guided else cfg.min_matches)
    loop_ransac = dataclasses.replace(ransac, inlier_threshold_px=cfg.verify_threshold_px,
                                      min_inliers=ransac_bar, rot_only_rescue=rot_only_rescue)
    if guided:
        xy_q, xy_t, ok, ok_loose = _match_against_slot(feats, db, slot, cfg.ratio,
                                                       cfg.guided_ratio)
    else:
        xy_q, xy_t, ok = _match_against_slot(feats, db, slot, cfg.ratio)
    delta = epipolar.estimate_relative_pose(xy_q, xy_t, ok, K, loop_ransac, sampler)
    if guided:
        delta = _guided_rematch(delta, xy_q, xy_t, ok_loose, K, cfg)
    # the boosted inlier mask lives in the loose tier (strict within
    # loose), so the masks downstream must too
    ok_eff = ok_loose if guided else ok
    passed = delta.success & (delta.num_inliers >= cfg.min_matches)
    t_use = _loop_scale(delta, xy_q, xy_t, ok_eff, K, scale_mode, scene_depth, depths,
                        depth_mask, depth_scale, scale_corr)
    par, _ = epipolar.mean_parallax_deg(delta, xy_q, xy_t, ok_eff, K)
    return (passed, delta.num_inliers, lie.se3_matrix(delta.R, t_use),
            epipolar.parallax_t_weight(par))


def detect(db: KeyframeDB, feats: Features, frame_id, K, cfg: LoopClosureConfig,
           ransac: RansacConfig, sampler, scale_mode: str = "unit", scene_depth: float = 4.0,
           depths=None, depth_mask=None, depth_scale=None) -> LoopResult:
    """Online loop detection for one frame against the DB before its
    insert: the histogram prefilter, the exact scores of the PREFILTER_K
    candidates (one match kernel launch, N = 8), the gates, and the
    verification of the top_k_candidates best (one more launch, N = 5,
    and one batched RANSAC; sampler stages "essential" / "homography",
    the pairs on the leading axis). A candidate passes with a score
    above 0; the first that passes in score order is the loop (parity:
    the reference's ordered early exit, LoopClosure.cpp:41-66).

    Nothing can pass when no top score is above 0, and then the verify is
    skipped and the empty LoopResult returned: the same result, for one
    read on the host a frame, where the verify would cost its launches on
    every frame without a candidate (most frames). Counters
    (utils/profiling.count): online.loop_queries (frames that verify),
    online.loop_verified (their candidates with a top score above 0)."""
    dev = feats.desc.device
    fid = torch.as_tensor(frame_id, dtype=torch.int32, device=dev)
    hist_q = descriptor_histogram(feats.desc, feats.valid)
    _, cand_slots = _gated_candidates(db, hist_q, fid, cfg, PREFILTER_K)
    scores = score_candidates(db, feats, cand_slots, cfg)
    # the gates again on the exact score (a small DB yields gated-out slots)
    cand_fid = db.frame_id[cand_slots]
    gated = ((cand_fid >= 0) & (fid - cand_fid >= cfg.min_frames_between)
             & (scores >= max(cfg.min_score, cfg.candidate_score_floor)))
    top_scores, top_pos = top_k_stable(torch.where(gated, scores, -1.0), cfg.top_k_candidates)
    candidates = int((top_scores > 0).sum())
    if not candidates:
        return no_loop(dev)
    count("online.loop_queries")
    count("online.loop_verified", candidates)
    top_slots = cand_slots[top_pos]
    v = top_slots.shape[0]

    def rows(x):  # the query for each candidate (the match kernel takes contiguous rows)
        return x.expand((v,) + x.shape).contiguous()

    passed, inliers, Ts, twts = verify_candidate(
        db, feats.map(rows), top_slots, K, cfg, ransac, sampler, scale_mode, scene_depth,
        *((None, None, None) if depths is None
          else (rows(depths), rows(depth_mask), rows(torch.as_tensor(depth_scale)))),
        rot_only_rescue=False)
    passed = passed & (top_scores > 0.0)
    any_pass = passed.any()
    first = torch.argmax(passed.to(torch.int32))  # the first True
    return LoopResult(
        detected=any_pass,
        slot=torch.where(any_pass, top_slots[first], -1).to(torch.int32),
        frame_id=torch.where(any_pass, db.frame_id[top_slots[first]], -1).to(torch.int32),
        score=torch.where(any_pass, top_scores[first], 0.0),
        num_inliers=torch.where(any_pass, inliers[first], 0).to(torch.int32),
        T_rel=torch.where(any_pass, Ts[first], torch.eye(4, device=dev)),
        t_weight=torch.where(any_pass, twts[first], 0.0))
