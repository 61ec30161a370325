"""Chunked offline SLAM evaluation (counterpart of the JAX package's
eval/chunked.py): the odometry path, loop closure and mapping.

Offline evaluation has the whole sequence on disk, so frames run in
chunks: one front-end pass extracts C+1 frames, matches the C consecutive
pairs and the C+1-lag wide-baseline pairs, and solves every pair's
two-view geometry in ONE batched RANSAC call (ops/epipolar.py takes a
leading pair axis), so the number of device launches a chunk is about
that of a single pair. The host then chains 4x4 poses, refines them by
chunk bundle adjustment, feeds the IMU metric-scale estimator and
extends the pose graph in chunk-sized batches.

Loop closure runs once a chunk as well: the histogram prefilter and the
exact candidate scores of all C frames against the keyframe DB before
this chunk's insert (`lc_query`, one match kernel launch for the C x 8
candidate pairs), then one batched verification of the best pairs
(`verify_batch`, one more launch), loop edges and a pose-graph
optimisation. The state commit triangulates the chunk's lag pairs
(i - lag, i) from the chunk-BA-refined chain into the padded map
(mapping/mapper.py). `snapshot` / `restore` keep the whole evaluator in
one npz with the JAX package's key names (`load_state` reads one).
Detection is not ported yet: asking for it raises NotImplementedError
naming the ROADMAP.md item that will port it.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np
import torch

from aria_slam_tpu_torch.backend import chunk_ba, keyframe_db, loop_closure, pose_graph
from aria_slam_tpu_torch.config import PipelineConfig
from aria_slam_tpu_torch.core.types import Features, KeyframeDB, MapState, PoseGraph
from aria_slam_tpu_torch.mapping import export, mapper
from aria_slam_tpu_torch.ops import epipolar, match as match_ops, orb
from aria_slam_tpu_torch.ops.undistort import undistort_points
from aria_slam_tpu_torch.pipeline.slam_pipeline import fetch_many, resolve_device

# the least number of loop-closure candidate pairs verified a chunk; the
# budget is max(VERIFY_MAX, chunk), so the per-frame budget stays the
# same as chunks grow
VERIFY_MAX = 16

# wide-baseline scale correction (config.vo_backbone_scale): per-chunk
# log-EMA gain on the median backbone/chain displacement ratio, and the
# per-chunk clamp
VIS_SCALE_GAIN = 0.5
VIS_SCALE_CLAMP = (0.3, 3.0)
VIS_SCALE_MIN_PAIRS = 4

# multi-view landmark-depth scale pin (config.ba_scale_pin): per-chunk
# log-EMA gain toward scene_depth / geomean(BA landmark depth), the
# per-chunk target clamp, and the minimum count of well-conditioned
# landmarks before a chunk's statistic counts
BA_PIN_GAIN = 0.5
BA_PIN_CLAMP = (0.5, 2.0)
BA_PIN_MIN_LANDMARKS = 50.0

# flag -> the ROADMAP.md queue-1 item that ports it
_UNPORTED = {
    "enable_detection": "queue 1 item 8 (detector)",
}

# per-pair statistics process_chunk reads on the host, fetched together
_FETCH_KEYS = ("R", "t", "ok", "pins", "ratios", "rcounts",
               "pin_oks", "pinl", "okl", "pinokl", "Rl", "tl")


def scatter_last(index: torch.Tensor, values: torch.Tensor, size: int) -> torch.Tensor:
    """zeros(..., size) with values (..., N) written at index (..., N)
    along the last axis. Where several slots write to one place, the
    highest slot wins, on the CPU and on the card alike (the reference's
    `.at[idx].set` keeps its last update on the CPU and leaves the choice
    open elsewhere): the winning slot is found by a scatter-max of the
    slot numbers, then its value is gathered."""
    n = index.shape[-1]
    slots = torch.arange(n, device=index.device).expand(index.shape)
    winner = torch.full(index.shape[:-1] + (size,), -1, dtype=torch.int64,
                        device=index.device).scatter_reduce(-1, index, slots, "amax",
                                                            include_self=True)
    picked = torch.take_along_dim(values, winner.clamp(min=0), -1)
    return torch.where(winner >= 0, picked, torch.zeros((), dtype=values.dtype,
                                                        device=values.device))


def extract(frames: torch.Tensor, cfg: PipelineConfig) -> Features:
    """(C+1, H, W) uint8 (or float) frames -> undistorted Features with a
    leading frame axis. All geometry downstream is pinhole."""
    feats = orb.extract_batch(frames.to(torch.float32), cfg.orb)
    return feats.replace(xy=undistort_points(feats.xy, cfg.camera))


def pairs(feats: Features, zlast, mlast, sampler, gyro_R, gyro_ok,
          cfg: PipelineConfig, lag: int) -> dict:
    """The chunk's pair geometry from its C+1 frames of features.

    Consecutive pairs are matched once with two ratio gates (strict for
    RANSAC, loose and epipolar-gated for the feature tracks of chunk BA);
    the lag pairs (i-lag, i) get their own match. All pairs, consecutive
    then lag, go through ONE gyro-fused essential RANSAC call, then the
    depth pins, the pair-to-pair scale ratios through the shared frame
    and the track links. zlast / mlast: the previous chunk's last-frame
    unit depths and mask. gyro_R (C, 3, 3) / gyro_ok (C,): per-pair
    rotation priors. Returns the reference front end's `out` dict."""
    dev = feats.xy.device
    K = torch.as_tensor(cfg.camera.K, device=dev)
    nframes, nf = feats.valid.shape
    c = nframes - 1
    prev = feats.map(lambda x: x[:-1])
    cur = feats.map(lambda x: x[1:])
    # one Hamming pass, two gates
    best2, second2, bidx2 = match_ops.match_batched_raw(cur, prev)
    tidx = bidx2.long()
    strict = match_ops.ratio_gate(cur.valid, best2, second2, cfg.matcher.ratio)
    prev_ok = torch.take_along_dim(prev.valid, tidx, 1)
    xy_prev = torch.take_along_dim(prev.xy, tidx[..., None], 1)
    valid = strict & prev_ok

    focal = 0.5 * (K[0, 0] + K[1, 1])
    in_thresh_sq = (cfg.ransac.inlier_threshold_px / focal) ** 2

    # wide-baseline pairs (i-lag, i): consecutive frames sit under the
    # 1-degree parallax gate
    lprev = feats.map(lambda x: x[:-lag])
    lcur = feats.map(lambda x: x[lag:])
    ml = match_ops.match_batched(lcur, lprev, cfg.matcher.ratio)
    lidx = ml.train_idx.long()
    uvl_prev = torch.take_along_dim(lprev.xy, lidx[..., None], 1)
    lvalid = ml.valid & torch.take_along_dim(lprev.valid, lidx, 1)

    with_lag = ((cfg.pose_graph.backbone_weight > 0 or cfg.vo_backbone_scale)
                and cfg.vo_scale_mode != "unit")
    xy1, xy2, vv, Rg, okg = xy_prev, cur.xy, valid, gyro_R, gyro_ok
    if with_lag:
        # composed gyro prior over each lag window: D_{i->i+L} =
        # D_{i+L-1} ... D_i, the chain's convention
        nlag = nframes - lag
        Rg_lag, ok_lag = gyro_R[:nlag], gyro_ok[:nlag]
        for s_ in range(1, lag):
            Rg_lag = gyro_R[s_:s_ + nlag] @ Rg_lag
            ok_lag = ok_lag & gyro_ok[s_:s_ + nlag]
        xy1, xy2 = torch.cat([xy_prev, uvl_prev]), torch.cat([cur.xy, lcur.xy])
        vv = torch.cat([valid, lvalid])
        Rg, okg = torch.cat([gyro_R, Rg_lag]), torch.cat([gyro_ok, ok_lag])

    # gyro fusion: with the pair rotation known from the integrated gyro
    # the translation is a linear re-estimate under that rotation, which
    # keeps (R, t) self-consistent for the consumers below
    delta_all = epipolar.estimate_pose_gyro_fused(
        xy1, xy2, vv, K, cfg.ransac, sampler, Rg, okg, in_thresh_sq)
    # the pin statistic may use the t-free estimator; the chain ratios
    # stay on the triangulated z1 / z2
    pz, pgood = epipolar.pin_depths(delta_all, xy1, xy2, vv, K,
                                    cfg.vo_pin_estimator, cfg.vo_pin_sigma_px)
    pins_all, pin_oks_all = epipolar.pin_scale(pz, pgood, cfg.vo_scene_depth)
    delta = delta_all.map(lambda x: x[:c])

    # unit-|t| depths for the scale chain: z1 at the prev frame (scattered
    # to prev slots for the frame shared with the previous pair), z2 at
    # the cur frame (carried to the next pair)
    z1, z2, zgood = epipolar.pair_depths(delta, xy_prev, cur.xy, valid, K)
    ZP = scatter_last(tidx, torch.where(zgood, z1, 0.0), nf)
    MP = scatter_last(tidx, zgood, nf)
    Z2 = torch.where(zgood, z2, 0.0)
    M2 = zgood & delta.success[:, None]
    CINL = delta.inlier_mask & valid

    # pair-to-pair scale ratios through the shared frame
    prev_z = torch.cat([zlast[None], Z2[:-1]])
    prev_m = torch.cat([mlast[None], M2[:-1]])
    ratios, rcounts = epipolar.geomean_ratio(prev_z, ZP, prev_m & MP)

    R, t, ok = delta.R, delta.t, delta.success
    out = {
        "R": R, "t": t, "ok": ok, "ninl": delta.num_inliers,
        "pins": pins_all[:c], "pin_oks": pin_oks_all[:c],
        "ratios": ratios, "rcounts": rcounts,
        "Z2": Z2, "M2": M2,
        "uvl_prev": uvl_prev, "uvl_cur": lcur.xy, "lvalid": lvalid,
        "desc": cur.desc, "xy": cur.xy, "dvalid": cur.valid,
        "hists": keyframe_db.descriptor_histogram(cur.desc, cur.valid),  # (C, 256)
    }

    if cfg.chunk_ba.enabled:
        # chunk BA inputs: the undistorted keypoints and the consecutive-
        # pair track links, from the loose ratio tier gated by each
        # pair's estimated epipolar geometry (recall drives track length)
        loose = match_ops.ratio_gate(cur.valid, best2, second2,
                                     cfg.matcher.track_ratio) & prev_ok
        egate = (cfg.matcher.track_epipolar_px / focal) ** 2
        s = epipolar.sampson_error(epipolar.lax_skew_E(R, t),
                                   epipolar.normalize_points(xy_prev, K),
                                   epipolar.normalize_points(cur.xy, K))
        track_ok = loose & (s < egate)
        out["fxy"] = feats.xy          # (C+1, N, 2)
        out["fvalid"] = feats.valid    # (C+1, N)
        out["midx"] = bidx2.to(torch.int32)   # (C, N)
        out["cinl"] = torch.where(ok[:, None], track_ok | CINL, CINL)

    if with_lag:
        # the lag pairs' RANSAC: the scale correction's lag-pin source
        # (config.vo_backbone_scale) and, with backbone_weight > 0,
        # weighted pose-graph edges beside the chain
        out["Rl"], out["tl"] = delta_all.R[c:], delta_all.t[c:]
        out["okl"] = delta_all.success[c:]
        out["pinl"], out["pinokl"] = pins_all[c:], pin_oks_all[c:]
    return out


def lc_query(db: KeyframeDB, hists, fids, desc, dvalid, cfg: PipelineConfig):
    """The histogram prefilter and the exact candidate scores of a chunk
    (one match kernel launch over its C x k pairs; the repeated query
    descriptors take 131 MB at C = 32, F = 2000) -> (sims (C, k), slots
    (C, k), scores (C, k))."""
    sims, slots = loop_closure.batch_candidates(db, hists, fids, cfg.loop)
    return sims, slots, loop_closure._full_scores(db, desc, dvalid, slots, cfg.loop.ratio)


def verify_batch(db: KeyframeDB, desc, xy, dvalid, z2, m2, scales, fidx, slots, sampler,
                 scale_corr, cfg: PipelineConfig, K):
    """Geometric verification of (chunk frame fidx, DB slot) pairs at
    once, fidx / slots (V,). z2 / m2 / scales: the chunk's odometry unit
    depths, their mask and the pairs' metric scales, so loop-edge
    translations land in the odometry's metric; scale_corr: the
    correction those scales were built with. -> (passed, num_inliers,
    T_rel (V, 4, 4), t_weight)."""
    kq = desc.shape[1]
    v = fidx.shape[0]
    zeros = torch.zeros((v, kq), dtype=torch.float32, device=desc.device)
    feats = Features(xy=xy[fidx], response=zeros, angle=zeros,
                     octave=zeros.to(torch.int32), size=zeros, desc=desc[fidx],
                     valid=dvalid[fidx])
    return loop_closure.verify_candidate(
        db, feats, slots, K, cfg.loop, cfg.ransac, sampler, cfg.vo_scale_mode,
        cfg.vo_scene_depth, depths=z2[fidx], depth_mask=m2[fidx], depth_scale=scales[fidx],
        scale_corr=scale_corr)


class ChunkedSlam:
    """Offline chunked evaluator: the trajectory and loops of
    SlamPipeline at batch throughput, with chunk BA, the IMU metric
    scale, the pose-graph chain and loop closure.

    Runs on CUDA unless `device` says otherwise (a missing card raises).
    RANSAC draws from an explicit torch.Generator seeded with `seed`, or
    from `sampler` when given (see ops/epipolar.py); the loop
    verification calls it with the stage "loop_essential" /
    "loop_homography". timer: optional utils.profiling.StageTimer for the
    per-stage breakdown (frontend / chunk_ba / imu_scale / loop_query /
    state_update / backbone_edges / loop_verify / loop_optimize)."""

    def __init__(self, config: PipelineConfig, chunk: int = 16, seed: int = 0,
                 timer=None, device=None, sampler=None):
        for flag, item in _UNPORTED.items():
            if getattr(config, flag):
                raise NotImplementedError(
                    f"{flag}=True is not ported to aria_slam_tpu_torch's ChunkedSlam yet; "
                    f"see ROADMAP.md {item}. Set it to False for the odometry path.")
        self.cfg = config
        self.chunk = chunk
        self.device = resolve_device(device)
        self._timer = timer
        if sampler is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            sampler = epipolar.TorchSampler(gen)
        self._sampler = sampler
        self.K = torch.as_tensor(config.camera.K, device=self.device)
        self.lag = max(1, min(config.mapper.pair_lag, chunk))

        # chain-edge translation weight: down-weighted only when the
        # backbone carries the better-conditioned translations
        backbone_on = (config.pose_graph.backbone_weight > 0
                       and config.vo_scale_mode != "unit")
        self._odom_twt = config.pose_graph.odom_t_weight if backbone_on else 1.0

        # state
        self.graph = pose_graph.init_graph(config.pose_graph, self.device)
        self.graph = pose_graph.set_node(self.graph, 0, torch.eye(4, device=self.device))
        self.db = (keyframe_db.init_db(config.loop, config.orb, self.device)
                   if config.enable_loop_closure else None)
        self.map_state = mapper.init_map(config.mapper, self.device)
        self.T = np.eye(4, dtype=np.float32)
        self.frame_count = 0
        self.num_loops = 0
        # accepted loop edges as (matched_node, query_node) frame ids
        self.loop_pairs: list = []
        # opt-in loop-closure diagnostics: set to [] before a run to collect,
        # a chunk, the prefilter candidates' frame ids, the exact scores, the
        # budget selection and the verify verdicts (one more fetch a chunk
        # that verifies), with the JAX package's keys. eval/longrun.py
        # attributes each missed loop to a stage from them (--diag).
        self.lc_diag: list | None = None
        self._db_head = 0  # host mirror of db.head
        self.trajectory: list = []
        self.last_ok = np.zeros((0,), bool)  # the last chunk's per-pair success flags
        # scale-propagation carry: last frame's unit depths (device) and
        # the running metric scale (host scalar)
        nf = config.orb.num_features
        self._zlast = torch.zeros((nf,), dtype=torch.float32, device=self.device)
        self._mlast = torch.zeros((nf,), dtype=torch.bool, device=self.device)
        self._scale = 1.0
        # IMU metric-scale correction (fusion/vi_init.ScaleEstimator,
        # created on the first chunk that carries IMU data)
        self._scale_est = None
        self._imu_corr = 1.0
        # wide-baseline scale correction (config.vo_backbone_scale): local
        # in median_depth mode (_chain_scales), a global EMA in propagate
        # mode; _vis_local is the trailing chunk-median fallback
        self._vis_corr = 1.0
        self._vis_local = 1.0
        # multi-view landmark-depth pin correction (config.ba_scale_pin)
        self._ba_corr = 1.0

    def _st(self, name: str):
        """Stage-timing context (no-op without a timer)."""
        return (self._timer.stage(name) if self._timer is not None
                else contextlib.nullcontext())

    def _frontend(self, frames, gyro_R, gyro_ok) -> dict:
        feats = extract(frames, self.cfg)
        return pairs(feats, self._zlast, self._mlast, self._sampler, gyro_R, gyro_ok,
                     self.cfg, self.lag)

    def _chain_scales(self, out, c) -> np.ndarray:
        """Per-pair metric scales. "propagate": s_k = s_{k-1} * ratio_k
        through shared features (fallback: scene-depth pin, else keep);
        "median_depth": per-pair pin; "unit": 1. The IMU metric correction
        multiplies the pinned scales last."""
        mode = self.cfg.vo_scale_mode
        if mode == "unit":
            return np.ones(c, np.float32)
        corr = self._imu_corr * self._vis_corr * self._ba_corr
        pins = np.asarray(out["pins"])
        if mode == "median_depth":
            if self.cfg.vo_backbone_scale and "pinl" in out:
                # local wide-baseline correction: each consecutive pin's
                # magnitude is replaced by the lag-window pin's, shared
                # out within the window by the consecutive pins' relative
                # sizes. Median over the <= lag windows covering a pair;
                # chunk-median fallback for edge pairs; trailing value
                # for a chunk with no valid window.
                pinl = np.asarray(out["pinl"])
                okw = (np.asarray(out["okl"]) & np.asarray(out["pinokl"])
                       & np.isfinite(pinl))
                nlag = pinl.shape[0]
                lag = self.lag
                sums = np.array([pins[w:w + lag].sum() for w in range(nlag)], np.float32)
                okw = okw & (sums > 1e-6) & (pinl > 1e-6)
                r_w = np.where(okw, pinl / np.maximum(sums, 1e-6), 1.0)
                logr = np.log(np.clip(r_w, 1e-3, 1e3))
                if okw.any():
                    self._vis_local = float(np.exp(np.median(logr[okw])))
                loc = np.full(c, self._vis_local, np.float32)
                for k in range(c):
                    lo = max(0, k - lag + 1)
                    hi = min(k, nlag - 1)
                    cover = np.arange(lo, hi + 1)
                    cover = cover[okw[cover]] if len(cover) else cover
                    if len(cover):
                        loc[k] = np.exp(np.median(logr[cover]))
                pins = pins * loc
            return np.clip(pins * corr, 1e-4, 1e4)
        ratios = np.asarray(out["ratios"])
        rcounts = np.asarray(out["rcounts"])
        pin_oks = np.asarray(out["pin_oks"])
        ok = np.asarray(out["ok"])
        scales = np.ones(c, np.float32)
        s = self._scale
        for i in range(c):
            if ok[i]:
                if rcounts[i] >= 10:
                    s = s * float(ratios[i])
                elif pin_oks[i]:
                    s = float(pins[i])  # chain broken: re-anchor
            scales[i] = np.clip(s * corr, 0.01, 100.0)
        self._scale = float(np.clip(s, 0.01, 100.0))
        return scales

    def _refine_chunk(self, out, T_start, poses_np, c, gyro_full, corr_before):
        """Chunk BA over the chained poses, in 16-frame sub-windows for
        chunks above 32 (the joint step's scratch grows with frames^2 x
        features). Returns (poses (C, 4, 4), rels (C, 4, 4)) or None when
        a window came back non-finite; updates the BA depth pin."""
        cfg = self.cfg
        dev = self.device
        poses_all = np.concatenate([T_start[None], poses_np], 0).astype(np.float32)
        rs = 0.0 if gyro_full else 1.0
        pin_on = cfg.ba_scale_pin and cfg.vo_scale_mode != "unit"
        W = c if c <= 32 else 16
        refined = poses_all.copy()
        zlog_sum = 0.0
        zcnt_sum = 0.0
        for s in range(0, c, W):
            e = min(s + W, c)
            rl = e - s
            if rl == W:
                poses_in = torch.from_numpy(refined[s:e + 1]).to(dev)
                fxy_in, fv_in = out["fxy"][s:e + 1], out["fvalid"][s:e + 1]
                mi_in, ci_in = out["midx"][s:e], out["cinl"][s:e]
            else:
                # ragged tail: pad the window to W by repeating the last
                # frame with dead links (cinl False -> single-observation
                # tracks of weight 0; fvalid False kills the pad frames)
                fidx = np.concatenate([np.arange(s, e + 1), np.full(W - rl, e)])
                pidx = np.concatenate([np.arange(s, e), np.zeros(W - rl, np.int64)])
                pad_f = torch.from_numpy(np.concatenate(
                    [np.ones(rl + 1, bool), np.zeros(W - rl, bool)])).to(dev)
                pad_p = torch.from_numpy(np.concatenate(
                    [np.ones(rl, bool), np.zeros(W - rl, bool)])).to(dev)
                fidx_t, pidx_t = torch.from_numpy(fidx).to(dev), torch.from_numpy(pidx).to(dev)
                poses_in = torch.from_numpy(refined[fidx]).to(dev)
                fxy_in = out["fxy"][fidx_t]
                fv_in = out["fvalid"][fidx_t] & pad_f[:, None]
                mi_in = out["midx"][pidx_t]
                ci_in = out["cinl"][pidx_t] & pad_p[:, None]
            end_before = refined[e].copy()
            r_win, _, _, geo_z, zcnt = chunk_ba.refine(
                poses_in, fxy_in, fv_in, mi_in, ci_in, self.K, cfg.chunk_ba, rs)
            # one copy a window: the poses and, when the lever is on, the
            # two pin scalars
            got = fetch_many([r_win, geo_z, zcnt] if pin_on else [r_win])
            r_win = got[0][:rl + 1]
            if not np.all(np.isfinite(r_win)):
                return None
            if pin_on:
                gz, zc = float(got[1]), float(got[2])
                if np.isfinite(gz) and gz > 0 and zc > 0:
                    zlog_sum += np.log(gz) * zc
                    zcnt_sum += zc
            # chain the window's end-pose correction into all later poses
            refined[s:e + 1] = r_win
            if e < c:
                refined[e + 1:] = (r_win[-1] @ np.linalg.inv(end_before)) @ refined[e + 1:]
        if pin_on and zcnt_sum >= BA_PIN_MIN_LANDMARKS:
            # the BA landmark geomean depth in the chain's current metric,
            # divided by corr_before, is a correction-invariant statistic
            # whose target correction is scene_depth / that geomean
            geo_raw = np.exp(zlog_sum / zcnt_sum) / corr_before
            target = float(np.clip(cfg.vo_scene_depth / max(geo_raw, 1e-6), *BA_PIN_CLAMP))
            self._ba_corr = float(np.exp((1.0 - BA_PIN_GAIN) * np.log(self._ba_corr)
                                         + BA_PIN_GAIN * np.log(target)))
        rels = np.einsum("nij,njk->nik", np.linalg.inv(refined[:-1]),
                         refined[1:]).astype(np.float32)
        return refined[1:], rels

    def process_chunk(self, frames: np.ndarray, timestamps,
                      gyro_R=None, gyro_ok=None, imu_window=None) -> None:
        """frames: (C+1, H, W); the first frame must be the previous
        chunk's last frame (overlap of 1), except in the first call.

        gyro_R / gyro_ok: optional (C, 3, 3) / (C,) per-pair rotation
        priors from fusion.gyro_prior: a valid prior replaces the two-view
        rotation in the chain and rescues failed pairs rotation-only.

        imu_window: optional (imu_ts, imu_accel, imu_gyro) raw IMU stream
        (full-sequence arrays are fine; windows are sliced by timestamp),
        feeding the accelerometer metric-scale estimator when
        cfg.imu_metric_scale."""
        cfg = self.cfg
        dev = self.device
        c_pairs = frames.shape[0] - 1
        use_gyro = (cfg.gyro_chain_rotation and gyro_R is not None
                    and gyro_ok is not None)
        if not use_gyro:
            gyro_R = np.tile(np.eye(3, dtype=np.float32), (c_pairs, 1, 1))
            gyro_ok = np.zeros((c_pairs,), bool)
        gyro_ok = np.asarray(gyro_ok, bool)
        with self._st("frontend"):
            # frames go up in their own dtype (uint8 from a reader): the
            # front end casts on the device
            fr = torch.from_numpy(np.ascontiguousarray(frames)).to(dev)
            out = self._frontend(fr, torch.from_numpy(np.asarray(gyro_R, np.float32)).to(dev),
                                 torch.from_numpy(gyro_ok).to(dev))
            # one copy lands every per-pair statistic the host chain reads
            keys = [k for k in _FETCH_KEYS if k in out]
            for k, h in zip(keys, fetch_many([out[k] for k in keys])):
                out[k] = h
            R, t, ok = out["R"], out["t"], out["ok"]
        self.last_ok = ok
        self._zlast = out["Z2"][-1]  # stays on the device for the next chunk
        self._mlast = out["M2"][-1]

        c = len(R)
        if self.frame_count == 0:
            self.trajectory.append((timestamps[0], self.T.copy()))
            self.frame_count = 1

        # ---- metric scale per pair (host chain over device statistics).
        # corr_before: the total correction these scales were built with;
        # every correction update below lands retroactively via the rebase
        # at the end of this method.
        scales = self._chain_scales(out, c)
        corr_before = self._imu_corr * self._vis_corr * self._ba_corr

        # ---- accumulate world poses on the host. Edge measurements come
        # from the measured deltas, not from pose differences.
        poses, rels = [], []
        T = self.T
        T_start = T.copy()  # overlap-frame pose: the chunk BA gauge
        for i in range(c):
            # a pair with a gyro prior already holds the fused estimate; a
            # pair that failed even then keeps the gyro rotation alone
            has_g = use_gyro and bool(gyro_ok[i])
            if ok[i] or has_g:
                T_cur_prev = np.eye(4, dtype=np.float32)
                T_cur_prev[:3, :3] = R[i] if ok[i] else gyro_R[i]
                if ok[i]:
                    T_cur_prev[:3, 3] = t[i] * scales[i]
                rel = np.linalg.inv(T_cur_prev).astype(np.float32)
            else:
                rel = np.eye(4, dtype=np.float32)
            T = T @ rel
            poses.append(T.copy())
            rels.append(rel)
        self.T = T
        poses_np = np.stack(poses)
        rels = np.stack(rels)

        # ---- chunk-local multiview BA: the chunk-start pose is the
        # gauge; the refined relative motions replace the two-view rels
        gyro_full = use_gyro and bool(np.all(gyro_ok))
        if cfg.chunk_ba.enabled and "fxy" in out:
            with self._st("chunk_ba"):
                refined = self._refine_chunk(out, T_start, poses_np, c, gyro_full,
                                             corr_before)
                if refined is not None:
                    poses_np, rels = refined
                    self.T = poses_np[-1].copy()

        # ---- IMU metric scale: the updated correction applies from the
        # next chunk on, plus a retroactive rebase of the recorded state
        # below when it moved by more than 2 %
        if (cfg.imu_metric_scale and imu_window is not None
                and cfg.vo_scale_mode != "unit"):
            with self._st("imu_scale"):
                if self._scale_est is None:
                    from aria_slam_tpu_torch.fusion.vi_init import ScaleEstimator

                    self._scale_est = ScaleEstimator(
                        R_cam_imu=np.asarray(cfg.imu_cam_rotation, np.float64),
                        device=dev)
                    # seed the window with the chunk-start pose
                    self._scale_est.update(np.asarray(timestamps[:1], np.float64),
                                           T_start[None], *imu_window)
                self._imu_corr = self._scale_est.update(
                    np.asarray(timestamps[1:], np.float64), poses_np, *imu_window)

        # ---- loop-closure query against the DB as it was before this
        # chunk's insert: at capacity the insert evicts the c oldest
        # keyframes, the likeliest revisit targets. It runs every chunk,
        # against an empty DB too.
        first_node = self.frame_count
        head_before = self._db_head
        if cfg.enable_loop_closure:
            # global frame index of each 'cur' frame; node id == frame id
            fids = torch.arange(first_node, first_node + c, dtype=torch.int32, device=dev)
            with self._st("loop_query"):
                query = fetch_many(lc_query(self.db, out["hists"], fids, out["desc"],
                                            out["dvalid"], cfg))

        # ---- post-chunk state commit: the pose-graph chain, the
        # keyframe-DB insert and the map insert
        chain_rwt = cfg.pose_graph.gyro_rot_weight if gyro_full else 1.0
        with self._st("state_update"):
            poses_dev = torch.from_numpy(poses_np).to(dev)
            self.graph = pose_graph.extend_chain(
                self.graph, poses_dev, torch.from_numpy(rels).to(dev), first_node,
                self._odom_twt, chain_rwt)
            if cfg.enable_loop_closure:
                self.db = keyframe_db.add_keyframes_batch(
                    self.db, out["desc"], out["xy"], out["dvalid"], fids, poses_dev)
                self._db_head = (head_before + c) % cfg.loop.max_keyframes
            if cfg.enable_mapping:
                # the lag pairs (i - lag, i) with camera-from-world ends
                # from the chunk-BA-refined chain and colours from the
                # later frame of each pair
                lag = self.lag
                all_poses = np.concatenate([T_start[None], poses_np], 0)
                self.map_state = mapper.add_from_matches_batched(
                    self.map_state, self.K,
                    torch.from_numpy(np.linalg.inv(all_poses[:c + 1 - lag])).to(dev),
                    torch.from_numpy(np.linalg.inv(all_poses[lag:])).to(dev),
                    out["uvl_prev"], out["uvl_cur"], out["lvalid"], fr[lag:], cfg.mapper)

        # ---- wide-baseline backbone (node i-lag -> node i)
        if "Rl" in out:
            self._backbone(out, scales, T_start, poses_np, first_node)

        if cfg.enable_loop_closure:
            self._close_loops(out, c, query, scales, corr_before, head_before)

        for i in range(c):
            self.trajectory.append((timestamps[i + 1], poses_np[i]))
        self.frame_count += c

        # ---- retroactive metric rebase: the correction estimates apply
        # to the whole raw chain, so a jump rescales everything recorded
        ratio = (self._imu_corr * self._vis_corr * self._ba_corr) / corr_before
        if abs(ratio - 1.0) > 0.02:
            self._retro_rescale(ratio)

    def _backbone(self, out, scales, T_start, poses_np, first_node) -> None:
        """The lag pairs' contribution: the propagate-mode global scale
        EMA, and weighted pose-graph edges when backbone_weight > 0."""
        cfg = self.cfg
        Rl, tl, pinl, okl = out["Rl"], out["tl"], out["pinl"], out["okl"]
        nlag = Rl.shape[0]  # == c + 1 - lag
        pins_c = out["pins"][:nlag]
        # chain displacement over each lag window
        pos_all = np.concatenate([T_start[None, :3, 3], poses_np[:, :3, 3]], 0)
        d_chain = np.linalg.norm(pos_all[self.lag:] - pos_all[:-self.lag], axis=1)
        # the lag pair's own metric: its depth pin carried into the
        # chain's current correction
        m_pin = pinl * scales[:nlag] / np.maximum(pins_c, 1e-6)
        pin_ok = okl & out["pinokl"]
        if cfg.vo_scale_mode == "propagate":
            pin_ok = pin_ok & out["pin_oks"][:nlag]
        if cfg.backbone_t_source == "chain":
            # magnitude from the chain, direction from the wide-baseline RANSAC
            tscale = d_chain
            bvalid = okl & (d_chain > 1e-6)
        else:  # "pin"
            tscale = m_pin
            bvalid = pin_ok
        if cfg.vo_backbone_scale and cfg.vo_scale_mode not in ("unit", "median_depth"):
            # propagate mode only: EMA the chain's metric toward the
            # lag-pair pin metric, over the arc length of each window
            d_arc = np.array([scales[w:w + self.lag].sum() for w in range(nlag)], np.float32)
            okv = pin_ok & np.isfinite(m_pin) & (d_arc > 1e-3)
            if int(okv.sum()) >= VIS_SCALE_MIN_PAIRS:
                r = float(np.clip(np.exp(np.median(np.log(m_pin[okv] / d_arc[okv]))),
                                  *VIS_SCALE_CLAMP))
                self._vis_corr = float(np.exp((1.0 - VIS_SCALE_GAIN) * np.log(self._vis_corr)
                                              + VIS_SCALE_GAIN * np.log(r)))
        if cfg.pose_graph.backbone_weight <= 0:
            return
        Tl = np.tile(np.eye(4, dtype=np.float32), (nlag, 1, 1))
        Tl[:, :3, :3] = Rl
        Tl[:, :3, 3] = tl * tscale[:, None]
        i_idx = first_node - 1 + np.arange(nlag, dtype=np.int32)
        j_idx = i_idx + self.lag
        # edge (i, j) measures T_i^-1 T_j = inv(T_{late<-early}); invalid
        # rows may hold garbage: gate them and invert in closed rigid form
        bvalid = bvalid & np.isfinite(Tl).all(axis=(1, 2))
        Tl[~bvalid] = np.eye(4, dtype=np.float32)
        RlT = np.transpose(Tl[:, :3, :3], (0, 2, 1))
        rels_l = np.tile(np.eye(4, dtype=np.float32), (nlag, 1, 1))
        rels_l[:, :3, :3] = RlT
        rels_l[:, :3, 3] = -np.einsum("nij,nj->ni", RlT, Tl[:, :3, 3])
        dev = self.device
        with self._st("backbone_edges"):
            self.graph = pose_graph.add_edges_batch(
                self.graph, torch.from_numpy(i_idx).to(dev), torch.from_numpy(j_idx).to(dev),
                torch.from_numpy(rels_l).to(dev), cfg.pose_graph.backbone_weight,
                torch.from_numpy(bvalid).to(dev))

    def _close_loops(self, out, c, query, scales, corr_before, head_before) -> None:
        """Verify the chunk's best (frame, candidate) pairs in one batch,
        add a loop edge for the first passing candidate of each frame and
        re-optimise the graph. query: the host copies of lc_query's
        (sims, slots, scores), taken before this chunk's insert."""
        cfg = self.cfg
        dev = self.device
        sims, slots_np, scores = query
        cap = cfg.loop.max_keyframes
        loop_found = False
        accepted_pairs: list = []  # (chunk fidx, matched DB slot)
        diag = None
        if self.lc_diag is not None:
            diag = {"base": int(self.frame_count), "c": int(c), "cand_fid": None,
                    "scores": None, "sel": [], "fidx": None, "passed": None}
            self.lc_diag.append(diag)
        if (sims[:, 0] > 0).any():
            scores[sims <= 0] = -1.0
            # the budget scales with the chunk, and the selection is
            # per-frame best first: every frame's top candidate competes
            # before any frame's second. The order of equal scores is
            # numpy's, as in the reference.
            vm = max(VERIFY_MAX, c)
            nk = scores.shape[1]
            rank = np.argsort(-scores, axis=1)  # per-frame ranking
            sel: list = []
            for r_ in range(nk):
                cols = rank[:, r_]
                vals = scores[np.arange(c), cols]
                for i in np.argsort(-vals):
                    if vals[i] >= cfg.loop.min_score:
                        sel.append(i * nk + cols[i])
            sel = sel[:vm]
            if diag is not None:
                # slots this chunk's insert overwrote now hold other
                # keyframes: flagged -2 (the rule of the live mask below)
                cand = self.db.frame_id.cpu().numpy()[slots_np]
                dead = (slots_np - head_before) % cap < c
                diag.update(cand_fid=np.where(dead, -2, cand), scores=scores.copy(),
                            sel=list(sel))
            if sel:
                # padded to vm pairs: fixed shapes on the card, fixed draws
                fidx = np.zeros(vm, np.int32)
                sl = np.zeros(vm, np.int32)
                live = np.zeros(vm, bool)
                for n_, p in enumerate(sel):
                    i, j = np.unravel_index(p, scores.shape)
                    fidx[n_] = i
                    sl[n_] = slots_np[i, j]
                    # the query read the pre-insert DB but verification
                    # gathers from the post-insert one: a candidate slot
                    # this chunk's insert overwrote holds another keyframe
                    live[n_] = (sl[n_] - head_before) % cap >= c
                with self._st("loop_verify"):
                    res = verify_batch(
                        self.db, out["desc"], out["xy"], out["dvalid"], out["Z2"], out["M2"],
                        torch.from_numpy(scales).to(dev),
                        torch.from_numpy(fidx).long().to(dev),
                        torch.from_numpy(sl).long().to(dev),
                        lambda v, h, s, stage: self._sampler(v, h, s, "loop_" + stage),
                        # the correction the chunk's scales were built with
                        torch.tensor(corr_before, dtype=torch.float32, device=dev),
                        cfg, self.K)
                    passed, n_inl, T_rels, twts, db_fids = fetch_many([*res, self.db.frame_id])
                    passed = passed & live
                if diag is not None:
                    diag.update(fidx=fidx.copy(), passed=passed.copy(), n_inliers=n_inl.copy())
                done_frames: set = set()
                for n_ in range(vm):
                    if not passed[n_] or int(fidx[n_]) in done_frames:
                        continue
                    done_frames.add(int(fidx[n_]))
                    node = self.frame_count + int(fidx[n_])
                    matched_node = int(db_fids[int(sl[n_])])
                    # T_rel = T_{matched<-current}: the edge measurement
                    # T_i^-1 T_j for (i = matched, j = node)
                    self.graph = pose_graph.add_loop_edge(
                        self.graph, matched_node, node, torch.from_numpy(T_rels[n_]).to(dev),
                        cfg.pose_graph, t_weight=float(twts[n_]))
                    self.num_loops += 1
                    self.loop_pairs.append((matched_node, node))
                    loop_found = True
                    accepted_pairs.append((int(fidx[n_]), int(sl[n_])))
                if loop_found:
                    with self._st("loop_optimize"):
                        self.graph = pose_graph.optimize(self.graph, cfg.pose_graph)
        if loop_found:
            # rebase the running pose on the optimised graph
            self.T = pose_graph.get_pose(self.graph, self.frame_count + c - 1).cpu().numpy()
            if self._scale_est is not None:
                # poses after the rebase live in a corrected world frame:
                # restart the alignment window (the correction survives)
                self._scale_est.reset_window()
        # covisibility: each accepted loop's matched keyframe (a live slot)
        # with the query frame's slot (written by the insert above)
        for fi, sl_ in accepted_pairs:
            self.db = keyframe_db.mark_covisible(self.db, sl_, (head_before + fi) % cap)

    def _retro_rescale(self, ratio: float) -> None:
        g = self.graph
        node_pose, edge_rel = g.node_pose.clone(), g.edge_rel.clone()
        node_pose[:, :3, 3] *= ratio
        edge_rel[:, :3, 3] *= ratio
        self.graph = g.replace(node_pose=node_pose, edge_rel=edge_rel)
        if self.db is not None:
            pose = self.db.pose.clone()
            pose[:, :3, 3] *= ratio
            self.db = self.db.replace(pose=pose)
        self.map_state = self.map_state.replace(points=self.map_state.points * ratio)
        self.T = self.T.copy()
        self.T[:3, 3] *= ratio
        traj = []
        for ts_, T_ in self.trajectory:
            T2 = T_.copy()
            T2[:3, 3] *= ratio
            traj.append((ts_, T2))
        self.trajectory = traj
        if self._scale_est is not None:
            self._scale_est.rebase_scale(ratio)

    def finalize(self):
        g = pose_graph.optimize(self.graph, self.cfg.pose_graph,
                                self.cfg.pose_graph.final_lm_iterations)
        self.graph = g
        n = len(self.trajectory)
        poses = g.node_pose[:n].cpu().numpy()
        self.trajectory = [(ts, poses[i]) for i, (ts, _) in enumerate(self.trajectory)]

    def get_map(self) -> MapState:
        return mapper.filter_outliers(self.map_state, self.cfg.mapper.outlier_sigma)

    def export_map(self, ply_path: Optional[str] = None,
                   pcd_path: Optional[str] = None) -> int:
        return export.export_map(self.get_map(), ply_path, pcd_path)

    def snapshot(self, path: str) -> None:
        """The evaluator's whole state in one npz, under the JAX package's
        key names (`load_state` reads it back): the pose graph, the
        keyframe DB (when loop closure is on) and the map as
        `<tree>.<field>`, the scale carry, the host scalars, the
        trajectory so far and the IMU scale estimator's window. The torch
        generator's state goes under `torch_rng`; the file has no JAX
        `rng` key, so the JAX package cannot restore it."""
        arrays = {}
        for name in _SNAP_TREES:
            obj = getattr(self, name)
            if obj is None:
                continue
            for f in dataclasses.fields(obj):
                arrays[f"{name}.{f.name}"] = getattr(obj, f.name).cpu().numpy()
        arrays["zlast"] = self._zlast.cpu().numpy()
        arrays["mlast"] = self._mlast.cpu().numpy()
        gen = getattr(self._sampler, "generator", None)
        if gen is not None:
            arrays["torch_rng"] = gen.get_state().numpy()
        arrays["T"] = self.T
        arrays["counters"] = np.array([self.frame_count, self.num_loops, self._db_head],
                                      np.int64)
        arrays["scales"] = np.array([self._scale, self._imu_corr, self._vis_corr,
                                     self._ba_corr, self._vis_local], np.float64)
        arrays["traj_ts"] = np.array([t for t, _ in self.trajectory], np.float64)
        arrays["traj_T"] = (np.stack([T for _, T in self.trajectory]) if self.trajectory
                            else np.zeros((0, 4, 4), np.float32))
        est = self._scale_est
        if est is not None:
            arrays["est_state"] = np.array(
                [est._corr, float(est._n_good), 1.0 if est._last_p is not None else 0.0],
                np.float64)
            arrays["est_last_p"] = est._last_p if est._last_p is not None else np.zeros(3)
            arrays["est_ts"] = np.asarray(est._ts, np.float64)
            arrays["est_inc"] = np.stack(est._inc) if est._inc else np.zeros((0, 3))
            arrays["est_tag"] = np.asarray(est._tag, np.float64)
            arrays["est_rwb"] = np.stack(est._Rwb) if est._Rwb else np.zeros((0, 3, 3))
            arrays["est_hist"] = (np.asarray(est._hist, np.float64) if est._hist
                                  else np.zeros((0, 2)))
        np.savez_compressed(path, **arrays)

    def restore(self, path: str) -> None:
        """Restore a snapshot (this port's or the JAX package's) into this
        evaluator; the configuration must be the one it was taken with."""
        with np.load(path) as data:
            load_state(self, data)


# device trees of the state file, under these attribute names
_SNAP_TREES = {"graph": PoseGraph, "db": KeyframeDB, "map_state": MapState}


def _tensor(x, device) -> torch.Tensor:
    return torch.from_numpy(np.array(x)).to(device)


def load_state(slam: ChunkedSlam, data) -> None:
    """Set `slam`'s state from the arrays of a state file: `data` maps the
    key names of `ChunkedSlam.snapshot` (the JAX package's) to numpy
    arrays, e.g. an `np.load` of the file.

    Older layouts load as the JAX package's `restore` loads them: two
    counters (the DB head mirror 0), two to four scales (the rest 1.0),
    no `est_hist`, a tree field missing from the file (a DB without
    `covis`) keeping its fresh value, and the positional `<tree>_<i>`
    layout while its leaf count matches. A tree the evaluator does not
    hold (the DB with loop closure off) is not read. A JAX file's `rng`
    is a JAX key that torch cannot continue: the evaluator keeps drawing
    from its own generator, as seeded, unless the file has `torch_rng`."""
    from aria_slam_tpu_torch.fusion.vi_init import ScaleEstimator

    dev = slam.device
    for name, cls in _SNAP_TREES.items():
        tmpl = getattr(slam, name)
        if tmpl is None:
            continue
        fields = [f.name for f in dataclasses.fields(cls)]
        if f"{name}.{fields[0]}" in data:
            setattr(slam, name, tmpl.replace(**{
                f: _tensor(data[f"{name}.{f}"], dev) for f in fields if f"{name}.{f}" in data}))
        else:
            try:
                leaves = [_tensor(data[f"{name}_{i}"], dev) for i in range(len(fields))]
            except KeyError as e:
                raise ValueError(
                    f"the state file uses the positional layout and the {name} state has "
                    f"since gained fields; re-create it with this version") from e
            setattr(slam, name, cls(*leaves))
    slam._zlast = _tensor(data["zlast"], dev)
    slam._mlast = _tensor(data["mlast"], dev)
    gen = getattr(slam._sampler, "generator", None)
    if gen is not None and "torch_rng" in data:
        gen.set_state(torch.from_numpy(np.array(data["torch_rng"])))
    slam.T = np.array(data["T"])
    counters, scales = np.asarray(data["counters"]), np.asarray(data["scales"])
    slam.frame_count = int(counters[0])
    slam.num_loops = int(counters[1])
    slam._db_head = int(counters[2]) if counters.shape[0] > 2 else 0
    slam._scale = float(scales[0])
    slam._imu_corr = float(scales[1])
    slam._vis_corr, slam._ba_corr, slam._vis_local = (
        float(scales[i]) if scales.shape[0] > i else 1.0 for i in (2, 3, 4))
    slam.trajectory = [(float(t), np.array(T)) for t, T in zip(data["traj_ts"], data["traj_T"])]
    slam._scale_est = None
    if "est_state" in data:
        est = ScaleEstimator(R_cam_imu=np.asarray(slam.cfg.imu_cam_rotation, np.float64),
                             device=dev)
        st = np.asarray(data["est_state"])
        est._corr = float(st[0])
        est._n_good = int(st[1])
        est._last_p = np.array(data["est_last_p"]) if st[2] > 0 else None
        est._ts = list(np.asarray(data["est_ts"]))
        est._inc = list(np.asarray(data["est_inc"]))
        est._tag = list(np.asarray(data["est_tag"]))
        est._Rwb = list(np.asarray(data["est_rwb"]))
        if "est_hist" in data:
            est._hist = [(float(a), float(b)) for a, b in np.asarray(data["est_hist"])]
        slam._scale_est = est
