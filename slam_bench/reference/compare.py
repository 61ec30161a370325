"""What decides `correct`: the program's outputs from the measured window
against the plain reference on the same inputs.

Each comparison reads the program's outputs only to judge them. Where a
stage can only be followed from the program's own state (the matcher
and the pose solver take the program's keypoints, descriptors and the
detector's dynamic-object mask, which the reference has checked by
themselves just before), the function says so. Every number is a
"worst" over the sample: higher is worse.
"""

from __future__ import annotations

import numpy as np
import torch

from slam_bench.reference import geometry as G
from slam_bench.reference.orb import Orb


def _keys(xy, level, valid):
    """Integer keys of keypoints: pyramid level and position (1/64 px);
    invalid slots -1."""
    k = ((level.long() * 1_000_003 + torch.round(xy[..., 0] * 64).long()) * 1_000_003
         + torch.round(xy[..., 1] * 64).long())
    return torch.where(valid, k, -1)


def orb_numbers(prog, ref):
    """prog / ref: dicts of xy (F, N, 2), level (F, N), valid (F, N),
    desc (F, N, B), angle (F, N). -> (kp_miss, desc_bits, desc_rows): the largest share
    over frames of the reference's keypoints the program lacks; the
    largest share of differing bits among the keypoints both have; and
    the count of those keypoints whose descriptors differ where rounding
    cannot explain it. A test bit is the sign of a difference of two
    bf16-rounded smoothed pixels; rounding of the smoothing (a float32
    sum) can move a pixel by one bf16 step, so a bit whose reference
    test value is within TEST_SLACK of 0 may go either way. The
    orientation, from sums of some 700 weighted pixels, can move by
    rounding too, and with it the steering bin: a keypoint whose angles
    lie within ANGLE_SLACK of each other in neighbouring bins is
    excused."""
    kp, kp_rows, bits, rows = 0.0, 0, 0.0, 0
    for f in range(ref["xy"].shape[0]):
        kr = _keys(ref["xy"][f], ref["level"][f], ref["valid"][f])
        kq = _keys(prog["xy"][f], prog["level"][f], prog["valid"][f])
        order = torch.argsort(kq)
        sq = kq[order]
        pos = torch.searchsorted(sq, kr).clamp(max=len(sq) - 1)
        found = (sq[pos] == kr) & ref["valid"][f]
        nref = int(ref["valid"][f].sum())
        kp = max(kp, 1.0 - int(found.sum()) / max(nref, 1))
        lvl, resp, valid = ref["level"][f].long(), ref["response"][f], ref["valid"][f]
        cut = torch.full((int(lvl.max()) + 1,), float("inf"), device=resp.device)
        cut = cut.scatter_reduce(0, lvl[valid], resp[valid], "amin")[lvl]
        tied = (resp - cut).abs() <= CUT_SLACK * cut.abs()
        kp_rows += int((valid & ~found & ~tied).sum())
        if found.any():
            slot = order[pos[found]]
            dq, dr = prog["desc"][f][slot], ref["desc"][f][found]
            bits = max(bits, float((dq != dr).float().mean()))
            differ = (dq != dr).any(-1)
            aq, ar = prog["angle"][f][slot], ref["angle"][f][found]
            d = torch.remainder(aq - ar + np.pi, 2 * np.pi) - np.pi
            step = (_bin(aq) - _bin(ar)) % BINS
            near = (step == 1) | (step == BINS - 1)
            tie = ref["tests"][f][found].abs() <= TEST_SLACK
            same_bin_fault = (step == 0) & ((dq != dr) & ~tie).any(-1)
            bin_fault = (step != 0) & ~(near & (d.abs() < ANGLE_SLACK))
            rows += int((differ & (same_bin_fault | bin_fault)).sum())
    return kp, kp_rows, bits, rows


# relative difference of Harris responses that summation order can make
CUT_SLACK = 1e-5
BINS = 30
# the orientation difference (rad) that rounding of the smoothed pixels
# can make through the moments: a tenth of a bin (0.21 rad)
ANGLE_SLACK = 0.02
# a test value (grey levels) that one bf16 step of a pixel in [128, 256)
# can flip
TEST_SLACK = 1.0


def _bin(angle):
    frac = torch.remainder(angle / (2 * np.pi), 1.0)
    return (frac * BINS + 0.5).to(torch.int64) % BINS


def pose_numbers(prog, ref, live, group):
    """prog / ref: dicts of R (P, 3, 3), t (P, 3), ok (P,), ninl (P,),
    pin (P,), pin_ok (P,); ref also gyro_ok (P,), the pairs with a gyro
    rotation. live (P,) bool selects the pairs compared; group (P,) int
    names each pair's group (a batch slot, or a chunk's consecutive or
    its lag pairs). -> dict of
      ok_flip: the share of pairs whose success differs;
      R_rows: pairs with a gyro rotation whose R lies more than
        R_SLACK_DEG from the reference's (the fused R is the gyro's);
      R_deg_max: the largest such angle (degrees);
      t_deg_p25: the first quartile of the angles (degrees) between the
        unit translations of the pairs both sides solved (a pair only one
        side solved is ok_flip's). Not the median, nor a group's: the
        program's RANSAC keeps another hypothesis than the reference's in
        27-47 % of pairs, 0.01-3 degrees apart, and in over three
        quarters of some groups (a batch slot, or a chunk's consecutive
        or lag pairs); t_deg_p50 / p90 the same at other quantiles;
        t_deg_group_p10 / p25 / p50 the worst group's (fewer than
        MIN_GROUP pairs are no group); t_big_share the share of pairs
        over 0.01 degrees;
      inl_gap_p50 (relative), pin_gap_p50 (relative, pairs both pinned)."""
    okp, okr = prog["ok"][live], ref["ok"][live]
    both = okp & okr
    a, b = prog["t"][live].double(), ref["t"][live].double()
    # atan2 of |a x b| and a . b resolves angles far below float32's arccos
    ang = torch.rad2deg(torch.atan2(torch.linalg.cross(a, b, dim=-1).norm(dim=-1),
                                    (a * b).sum(-1)))
    g = group[live]
    groups = [ang[both & (g == k)] for k in torch.unique(g[both]).tolist()]
    groups = [x for x in groups if x.numel() >= MIN_GROUP]
    rdeg = G.rotation_deg(prog["R"][live], ref["R"][live])[ref["gyro_ok"][live]]
    has = prog.get("has_ninl", torch.ones_like(live))[live]
    inl = ((prog["ninl"][live].float() - ref["ninl"][live].float()).abs()
           / ref["ninl"][live].float().clamp(min=1.0))[both & has]
    pb = both & prog["pin_ok"][live] & ref["pin_ok"][live]
    pin = ((prog["pin"][live] - ref["pin"][live]).abs()
           / ref["pin"][live].abs().clamp(min=1e-9))[pb]
    return dict(ok_flip=float((okp != okr).float().mean()) if okp.numel() else 0.0,
                R_rows=int((rdeg > R_SLACK_DEG).sum()),
                R_deg_max=float(rdeg.max()) if rdeg.numel() else 0.0,
                **{f"t_deg_group_p{round(100 * p)}": max((_q(x, p) for x in groups), default=0.0)
                   for p in (0.1, 0.25, 0.5)},
                t_big_share=float((ang[both] > 0.01).float().mean()) if both.any() else 0.0,
                t_deg_p25=_q(ang[both], 0.25), t_deg_p50=_q(ang[both], 0.5),
                t_deg_p90=_q(ang[both], 0.9), inl_gap_p50=_q(inl, 0.5),
                pin_gap_p50=_q(pin, 0.5))


# the angle (degrees) between two float32 roundings of one rotation: the
# program's fused R is the gyro's, integrated as the reference does it
R_SLACK_DEG = 1e-4


MIN_GROUP = 4


def _q(x, p):
    return float(torch.quantile(x.double(), p)) if x.numel() else 0.0


# COCO's classes that move: person, bicycle, car, motorcycle, bus, train,
# truck, bird, cat, dog (the reference system's dynamic-object filter)
DYNAMIC_CLASSES = (0, 1, 2, 3, 5, 6, 7, 14, 15, 16)
# the score and the box edge (px) that bf16 rounding of the detector's
# outputs can move: a keypoint decided by less is excused
CONF_SLACK = 0.02
EDGE_SLACK_PX = 2.0


def decode(outs, size, reg_max=16):
    """The detector's raw outputs [(box (N, 4 reg_max, h, w), cls (N, C,
    h, w))] per level -> boxes (N, A, 4) xyxy in input px (the expected
    distance of each edge's distribution, times the stride, from the cell
    centre) and scores (N, A, C) (sigmoid), anchors row-major per level."""
    boxes, scores = [], []
    for box, cls in outs:
        n, _, h, w = box.shape
        stride = size // h
        bins = torch.arange(reg_max, dtype=torch.float32, device=box.device)
        d = (box.float().reshape(n, 4, reg_max, h, w).softmax(2)
             * bins[:, None, None]).sum(2) * stride
        cy = (torch.arange(h, device=box.device, dtype=torch.float32) + 0.5) * stride
        cx = (torch.arange(w, device=box.device, dtype=torch.float32) + 0.5) * stride
        gy, gx = cy[:, None].expand(h, w), cx[None, :].expand(h, w)
        boxes.append(torch.stack([gx - d[:, 0], gy - d[:, 1], gx + d[:, 2], gy + d[:, 3]],
                                 -1).reshape(n, h * w, 4))
        scores.append(cls.float().sigmoid().permute(0, 2, 3, 1).reshape(n, h * w, -1))
    return torch.cat(boxes, 1), torch.cat(scores, 1)


def dynamic_mask(xy, outs, size, h, w, thresh, max_det, side=0):
    """(N, K) bool: the keypoints xy (N, K, 2) of (h, w) frames inside a
    box of a dynamic class among the `max_det` best-scoring anchors that
    reach `thresh` (the detector's raw outputs `outs`). side 0 decides
    exactly; side +1 keeps only what no rounding within CONF_SLACK and
    EDGE_SLACK_PX could undo (strict), side -1 all that such rounding
    could give (loose)."""
    boxes, scores = decode(outs, size)
    s, e = side * CONF_SLACK, side * EDGE_SLACK_PX
    conf = scores.amax(-1)
    dyn = torch.zeros(scores.shape[-1], dtype=torch.bool, device=scores.device)
    dyn[list(DYNAMIC_CLASSES)] = True
    best_dyn, best_other = scores[..., dyn].amax(-1), scores[..., ~dyn].amax(-1)
    asc = conf.sort(-1).values
    # anchors scoring at least v: what the max_det best can hold
    rank = conf.shape[-1] - torch.searchsorted(asc, (conf - s).contiguous(), side="left")
    keep = (conf >= thresh + s) & (rank <= max_det) & (
        best_dyn > best_other + s if side >= 0 else best_dyn >= conf + s)
    scale = torch.tensor([w / size, h / size, w / size, h / size], device=boxes.device)
    grow = torch.tensor([e, e, -e, -e], device=boxes.device)
    out = torch.zeros(xy.shape[:2], dtype=torch.bool, device=xy.device)
    for f in range(xy.shape[0]):
        b = boxes[f][keep[f]] * scale + grow
        if b.shape[0]:
            x, y = xy[f, :, None, 0], xy[f, :, None, 1]
            out[f] = ((x >= b[:, 0]) & (x <= b[:, 2]) & (y >= b[:, 1])
                      & (y <= b[:, 3])).any(-1)
    return out


def dynamic_rows(prog_mask, xy, valid, outs, size, h, w, thresh, max_det):
    """Valid keypoints whose dynamic-object flag the program sets where
    the reference's loose mask (from its own outputs `outs`) does not, or
    leaves clear where its strict mask sets it -> (rows, the program's
    share flagged, the reference's share flagged)."""
    strict = dynamic_mask(xy, outs, size, h, w, thresh, max_det, +1)
    loose = dynamic_mask(xy, outs, size, h, w, thresh, max_det, -1)
    bad = ((prog_mask & ~loose) | (~prog_mask & strict)) & valid
    n = max(int(valid.sum()), 1)
    return int(bad.sum()), int((prog_mask & valid).sum()) / n, int((strict & valid).sum()) / n


def detector_gap(prog_outs, ref_outs):
    """Per level and output (box distribution, class logits): the largest
    |program - reference| over the batch as a share of the reference's
    largest |value| there; the worst of them."""
    worst = 0.0
    for (pb, pc), (rb, rc) in zip(prog_outs, ref_outs):
        for p, r in ((pb, rb), (pc, rc)):
            worst = max(worst, float((p.float() - r).abs().max() / r.abs().max().clamp(min=1e-12)))
    return worst


def front_end(feats, pairs, valid_rule, K, ransac, draws, gyro_R, gyro_ok, ratio,
              scene_depth):
    """The reference's matcher and fused pose solver, followed from the
    program's features (xy (F, N, 2), valid, desc) over `pairs`
    (prev (P,), cur (P,) frame indices). valid_rule(prev_idx, cur_idx,
    best_idx, ratio_ok) -> (P, N) correspondence mask. -> dict of
    best_idx, valid, t, ok, ninl, pin, pin_ok, and the correspondences."""
    pi, ci = pairs
    best, second, idx = G.top2(feats["desc"][ci], feats["desc"][pi], feats["valid"][pi])
    gate = G.ratio_gate(feats["valid"][ci], best, second, ratio)
    valid = valid_rule(pi, ci, idx, gate)
    xy1 = torch.take_along_dim(feats["xy"][pi], idx[..., None], 1)
    xy2 = feats["xy"][ci]
    pose = G.fused_pose(xy1, xy2, valid, K, ransac, draws, gyro_R, gyro_ok)
    pin, pin_ok = G.pins(pose, xy1, xy2, valid, K, scene_depth)
    return dict(best_idx=idx, valid=valid, xy1=xy1, t=pose["t"], R=pose["R"], ok=pose["ok"],
                ninl=pose["ninl"], pin=pin, pin_ok=pin_ok)


def umeyama_ate(est, gt):
    """Sim3-aligned RMSE (m) of positions est against gt, both (N, 3)."""
    est, gt = np.asarray(est, np.float64), np.asarray(gt, np.float64)
    me, mg = est.mean(0), gt.mean(0)
    e, g = est - me, gt - mg
    U, S, Vt = np.linalg.svd(g.T @ e / len(est))
    D = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        D[2, 2] = -1
    R = U @ D @ Vt
    var = (e ** 2).sum() / len(est)
    s = np.trace(np.diag(S) @ D) / max(var, 1e-12)
    aligned = s * e @ R.T + mg
    return float(np.sqrt(((aligned - gt) ** 2).sum(1).mean()))


def loop_precision(pairs, gt_pos, radius=0.5):
    """Share of loop pairs (matched frame, query frame) whose ground-truth
    positions lie within `radius` m (1.0 with no loop), and the count."""
    if not pairs:
        return 1.0, 0
    good = [np.linalg.norm(gt_pos[a] - gt_pos[b]) < radius for a, b in pairs]
    return float(np.mean(good)), len(pairs)


__all__ = ["Orb", "orb_numbers", "pose_numbers", "detector_gap", "dynamic_mask", "dynamic_rows",
           "front_end", "umeyama_ate", "loop_precision"]
