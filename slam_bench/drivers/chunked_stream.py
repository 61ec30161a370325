"""Driver of a closed-loop stream of sequences through the chunked offline
evaluator (`ChunkedSlam.process_chunk`, then `finalize`), one sequence
after another, each in a fresh evaluator with its scene's RANSAC stream.

A unit of the window is one whole sequence, its chunks and its
`finalize`: an offline user has a sequence's trajectory once `finalize`
has run. The mix's fixed set of scenes is made on the card, kept on the
host and uploaded by `process_chunk` as the evaluator's reader would
hand frames over; the seed draws the scenes (their textures, the moving
panel's and the IMU's noise) and each scene's RANSAC stream. The
detector (YOLO at the configuration's size, weights drawn from the seed)
is built once and handed to every evaluator.

Checked after the window: a sample of chunks drawn from the seed, each
against the reference: ORB keypoints and descriptors of all its frames,
the detector's raw outputs and the dynamic-object mask decoded from
them, the gyro's pair rotations, the matcher, the fused pose and the
pins of every pair; and every finished sequence's loop closures and trajectory
against the scene's ground truth.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_bench.harness import inputs
from slam_bench.reference import compare, geometry as G, precision

# the seed-drawn sample: this many chunks of each of the first sequences
# of the window
SAMPLE = (2, 1, 1)


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfgj = run.cell.config
        self.tr = run.cell.traffic

    # ------------------------------------------------------------ set-up
    def setup(self):
        from aria_slam_tpu_torch.config import PipelineConfig
        from aria_slam_tpu_torch.eval import chunked
        from aria_slam_tpu_torch.models import detect, yolo

        run, tr = self.run, self.tr
        dev = run.device
        self.chunked = chunked
        self.cfg = PipelineConfig.from_dict(self.cfgj["pipeline"])
        self.chunk = self.cfgj["chunk"]
        self.n = tr["frames"]
        self.cam = inputs.camera(self.cfgj)
        # the mix's scenes, drawn from the seed; sequence q runs scene
        # q mod their number
        self.scenes = [inputs.scene(self.cam, tr, run.seed, i, self.n, dev)
                       for i in range(tr["scenes"])]
        self.times, self.gt = self.scenes[0][1], self.scenes[0][2]
        self.detector, self.model = None, None
        if self.cfg.enable_detection and self.cfg.enable_dynamic_filtering:
            det = self.cfg.detector
            self.weights = inputs.yolo_weights(dataclasses.asdict(det), run.seed, dev)
            self.model = yolo.make_model(det).to(dev)
            self.model.load_state_dict(self.weights)
            self.model.eval()
            self.model.register_forward_hook(self._det_hook)
            plain = detect.make_batched_detector(det, model=self.model, use_nms=False, device=dev)
            self.detector = self._timed(plain) if run.trace else plain
        # the evaluator is built without its own detector and handed this one
        self.slam_cfg = dataclasses.replace(self.cfg, enable_detection=False)
        self._orig_pairs = chunked.pairs
        chunked.pairs = self._pairs
        self.records, self._record, self._det_out = [], False, []
        self.sequences = []  # finished: (trajectory positions, loop pairs)
        self.seq_index = 0
        r = inputs.rng(run.seed, 4)
        nchunks = (self.n - 1) // self.chunk
        self.sample = {(1 + i, int(c)) for i, k in enumerate(SAMPLE)
                       for c in r.choice(nchunks, k, replace=False)}
        # warm-up: one whole sequence (index 0), which verifies and
        # optimises loops and finalizes; then the window starts at index 1
        self.step()
        self.sequences.clear()
        # what the step's operation count needs (readers.step_least_s)
        self.run.info.update(extract_frames=self.chunk + 1, features=self.cfg.orb.num_features,
                             detector=self.detector is not None)

    # ----------------------------------------------------------- hooks
    def _det_hook(self, module, args, out):
        if self._record:
            self._det_out.append(out)

    def _timed(self, detector):
        spans = self.run.spans

        def detect_batch(images):
            with spans.stage("detector"):
                return detector(images)
        return detect_batch

    def _pairs(self, feats, zlast, mlast, sampler, gyro_R, gyro_ok, cfg, lag, dyn_all=None,
               live=None):
        if not self._record:
            return self._orig_pairs(feats, zlast, mlast, sampler, gyro_R, gyro_ok, cfg, lag,
                                    dyn_all, live)
        rec = inputs.RecordingSampler(sampler)
        out = self._orig_pairs(feats, zlast, mlast, rec, gyro_R, gyro_ok, cfg, lag, dyn_all, live)
        self.records[-1].update(
            feats=dict(xy=feats.xy, valid=feats.valid, desc=feats.desc, angle=feats.angle,
                       level=feats.octave),
            dyn=dyn_all, live=live, lag=lag, calls=rec.calls,
            out={k: v for k, v in out.items() if isinstance(v, torch.Tensor)})
        return out

    # ------------------------------------------------------------ window
    def step(self) -> int:
        """One whole sequence in a fresh evaluator: its chunks, then
        `finalize`. -> its frames."""
        spans = self.run.spans
        q = self.seq_index
        self.seq_index += 1
        scene = q % len(self.scenes)
        slam = self.chunked.ChunkedSlam(
            self.slam_cfg, chunk=self.chunk, seed=inputs.sub_seed(self.run.seed, 5, scene),
            timer=spans if self.run.trace else None, device=self.run.device)
        slam._detector = self.detector
        frames, _, _, imu = self.scenes[scene]
        k, c = 0, 0
        while k < self.n - 1:
            k = self._chunk(slam, q, c, k, frames, imu, scene)
            c += 1
        with spans.stage("finalize"):
            slam.finalize()
        pos = np.stack([T[:3, 3] for _, T in slam.trajectory])
        self.sequences.append(dict(q=q, pos=pos, loops=list(slam.loop_pairs)))
        return len(slam.trajectory)

    def _chunk(self, slam, q, c, k, seq_frames, imu, scene) -> int:
        from aria_slam_tpu_torch.fusion import gyro_prior

        hi = min(k + self.chunk, self.n - 1)
        idx = np.arange(k, hi + 1)
        frames, ts = seq_frames[idx], self.times[idx]
        self._record = (q, c) in self.sample
        if self._record:
            self.records.append(dict(q=q, c=c, frames=frames, ts=ts, scene=scene))
            self._det_out = []
        with self.run.spans.stage("chunk"):
            gR, gok = gyro_prior.pair_rotations(imu[0], imu[2], ts)
            slam.process_chunk(frames, ts, gR, gok, imu_window=imu)
        if self._record:
            self.records[-1]["det"] = self._det_out
            self._record = False
        return hi

    # ------------------------------------------------------------- check
    def free(self):
        self.chunked.pairs = self._orig_pairs
        self.detector = self.model = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        self.free()
        if self.run.trace:
            self._least()
        return check_records(self, self.records)

    def _least(self):
        """Least times for the roofline readers: a launch of the corner
        and patch kernels (from four of the cell's frames), and the
        window's match launches."""
        from slam_bench import counts
        from slam_bench.harness.bounds import extract_least_s

        info, cfg, c = self.run.info, self.cfg, self.chunk
        with precision.mode("fp32"):
            info["corner_least_s"], info["patch_least_s"] = extract_least_s(
                torch.from_numpy(self.scenes[0][0][:4]).to(self.run.device),
                dataclasses.asdict(cfg.orb), c + 1)
        f = cfg.orb.num_features
        lag = c + 1 - max(1, min(cfg.mapper.pair_lag, c))
        vm = max(16, c)  # eval/chunked.VERIFY_MAX or the chunk
        per_chunk = [counts.match_bound(c, f, f), counts.match_bound(lag, f, f)]
        if cfg.enable_loop_closure:
            per_chunk.append(counts.match_bound(8 * c, f, f))  # PREFILTER_K candidates
        verifies = sum(1 for n, _, _ in self.run.spans.events if n == "loop_verify")
        chunks = sum(1 for n, _, _ in self.run.spans.events if n == "chunk")

        def match_least(launches):
            want = len(per_chunk) * chunks + verifies
            if launches != want:
                return None
            return chunks * sum(per_chunk) + verifies * counts.match_bound(vm, f, f)

        info["match_least_s"] = match_least
        info["extracts"] = chunks
        if self.cfg.enable_detection:
            det = self.cfg.detector
            info["yolo_flops"] = counts.yolo_flops(det.input_size, det.width_mult,
                                                   det.depth_mult, det.num_classes)


def check_records(drv, records, control=None):
    """The numbers that decide `correct` (worst over the sample). control:
    None to judge the program's recorded outputs, or a precision ("tf32")
    to judge the reference computed in it in the program's place."""
    dev = drv.run.device
    cfg = drv.cfg
    K = torch.as_tensor(cfg.camera.K, device=dev)
    orb_cfg = dataclasses.asdict(cfg.orb)
    ransac = dataclasses.asdict(cfg.ransac)
    nums = dict(orb_kp_miss=0.0, orb_kp_rows=0, orb_desc_bits=0.0, orb_desc_rows=0,
                match_rows=0, det_gap=0.0, dyn_rows=0, dyn_share=0.0, dyn_ref_share=0.0)
    poses = []
    with precision.mode("fp32"):
        orb_ref = compare.Orb(orb_cfg, dev)
    for k, rec in enumerate(r for r in records if "out" in r):
        frames = torch.from_numpy(rec["frames"]).to(dev)
        with precision.mode("fp32"):
            ref_feats = orb_ref.extract(frames)
        feats = rec["feats"]
        if control is not None:
            with precision.mode(control):
                feats = compare.Orb(orb_cfg, dev).extract(frames)
        kp, kp_rows, bits, rows = compare.orb_numbers(feats, ref_feats)
        nums["orb_kp_miss"] = max(nums["orb_kp_miss"], kp)
        nums["orb_kp_rows"] += kp_rows
        nums["orb_desc_bits"] = max(nums["orb_desc_bits"], bits)
        nums["orb_desc_rows"] += rows
        dyn = rec["dyn"]
        if rec.get("det"):
            dyn = detector_check(drv, rec, frames, feats, control, nums)
        p, r = pair_check(rec, feats, dyn, drv.scenes[rec["scene"]][3], K, ransac, cfg,
                          control)
        nums["match_rows"] += r.pop("match_rows")
        p["group"] = 2 * k + (torch.arange(len(p["ok"]), device=dev) >= frames.shape[0] - 1)
        poses.append((p, r))
    if poses:
        cat = {k: torch.cat([p[k] for p, _ in poses]) for k in poses[0][0]}
        rcat = {k: torch.cat([r[k] for _, r in poses]) for k in poses[0][1]}
        nums.update({"pose_" + k: v for k, v in
                     compare.pose_numbers(cat, rcat, cat.pop("live"), cat.pop("group")).items()})
    ates, precs, nloops = [], [], []
    for s in drv.sequences:
        ates.append(compare.umeyama_ate(s["pos"], drv.gt[: len(s["pos"])]))
        pr, n = compare.loop_precision(s["loops"], drv.gt)
        precs.append(pr)
        nloops.append(n)
    if ates:
        nums.update(ate_m=max(ates), loop_precision=min(precs), loops_min=min(nloops))
    nums["sampled_chunks"] = len(poses)
    nums["sequences"] = len(drv.sequences)
    return nums


def detector_check(drv, rec, frames, feats, control, nums):
    """YOLO in float32 on the chunk's frames with the same weights: the
    gap of the raw outputs, and the dynamic-object mask of the program's
    keypoints decoded from the reference's own outputs against the
    program's. -> the mask the pairs are followed with: the program's
    (judged here), or the control's own."""
    from slam_bench.reference import yolo as ry

    det = drv.cfg.detector
    h, w = frames.shape[-2:]
    with precision.mode("fp32"):
        x = ry.preprocess(frames, det.input_size)
        ref_out = ry.forward(drv.weights, x, det.width_mult, det.depth_mult, det.num_classes)
        prog_out, dyn = rec["det"][0], rec["dyn"]
        if control is not None:
            prog_out = ry.forward(drv.weights, x, det.width_mult, det.depth_mult,
                                  det.num_classes, quant=precision.fp8)
            dyn = compare.dynamic_mask(feats["xy"], prog_out, det.input_size, h, w,
                                       det.conf_threshold, det.max_detections)
        nums["det_gap"] = max(nums["det_gap"], compare.detector_gap(prog_out, ref_out))
        rows, share, ref_share = compare.dynamic_rows(
            dyn, feats["xy"], feats["valid"], ref_out, det.input_size, h, w,
            det.conf_threshold, det.max_detections)
    nums["dyn_rows"] += rows
    nums["dyn_share"] = max(nums["dyn_share"], share)
    nums["dyn_ref_share"] = max(nums["dyn_ref_share"], ref_share)
    return dyn


def pair_check(rec, feats, dyn, imu, K, ransac, cfg, control):
    """One chunk's pairs: the reference's gyro rotations from the scene's
    IMU, and its matcher and pose solver from the program's features and
    dynamic mask (followed from its state; both are checked above),
    against the program's outputs."""
    out = rec["out"]
    n = feats["xy"].shape[0]
    c = n - 1
    dev = feats["xy"].device
    # without lag pairs in the solve the lag slice is empty
    lag = rec["lag"] if "tl" in out else n
    dyn = dyn if dyn is not None else torch.zeros_like(feats["valid"])
    cons = (torch.arange(c), torch.arange(1, c + 1))
    lagp = (torch.arange(n - lag), torch.arange(lag, n))
    pi = torch.cat([cons[0], lagp[0]]).to(dev)
    ci = torch.cat([cons[1], lagp[1]]).to(dev)
    fv = feats["valid"]

    def rule(p_, c_, idx, gate):
        return gate & torch.take_along_dim(fv[p_] & ~dyn[p_], idx, 1) & ~dyn[c_]

    gR, gok = (torch.from_numpy(x).to(dev) for x in G.gyro_pairs(imu[0], imu[2], rec["ts"]))
    nl = n - lag
    draws = {stage: idx for stage, _, idx in rec["calls"]}
    prog_valid = rec["calls"][0][1]

    def solve(mode):
        with precision.mode(mode):
            Rl, okl = G.compose_lag(gR, gok, lag)
            Rg, okg = torch.cat([gR, Rl[:nl]]), torch.cat([gok, okl[:nl]])
            res = compare.front_end(feats, (pi, ci), rule, K, ransac, draws, Rg, okg,
                                    cfg.matcher.ratio, cfg.vo_scene_depth)
        res["gyro_ok"] = okg
        return res

    ref = solve("fp32")
    if control is None:
        live = torch.cat([out["ok"].new_ones(c) if rec["live"] is None else rec["live"],
                          out["okl"].new_ones(nl)])
        lagk = ("Rl", "tl", "okl", "pinl", "pinokl")
        Rl, tl, okl, pinl, pinokl = (out[k] if k in out else ref[r][c:]
                                     for k, r in zip(lagk, ("R", "t", "ok", "pin", "pin_ok")))
        prog = dict(R=torch.cat([out["R"], Rl]), t=torch.cat([out["t"], tl]),
                    ok=torch.cat([out["ok"], okl]),
                    ninl=torch.cat([out["ninl"], ref["ninl"][c:]]),
                    pin=torch.cat([out["pins"], pinl]), pin_ok=torch.cat([out["pin_oks"], pinokl]))
        rows = int((prog_valid != ref["valid"]).sum())
        if "midx" in out:
            rows += int(((out["midx"].long() != ref["best_idx"][:c]) & fv[1:]).sum())
        rows += int(((out["uvl_prev"] != torch.take_along_dim(
            feats["xy"][:n - rec["lag"]], ref_lag_idx(feats, rec["lag"], n), 1)).any(-1)
            & out["lvalid"]).sum())
    else:
        alt = solve(control)
        live = torch.ones_like(alt["ok"])
        if rec["live"] is not None:
            live[:c] = rec["live"]
        prog = {k: alt[k] for k in ("R", "t", "ok", "ninl", "pin", "pin_ok")}
        rows = int((alt["valid"] != ref["valid"]).sum())
    live = live.bool()
    prog["ok"] = prog["ok"] & live
    refd = {k: ref[k] for k in ("R", "t", "ok", "ninl", "pin", "pin_ok", "gyro_ok")}
    refd["ok"] = refd["ok"] & live
    prog["live"] = live
    # the program reports inlier counts of the consecutive pairs only
    prog["has_ninl"] = torch.arange(len(live), device=live.device) < c
    refd["match_rows"] = rows
    return prog, refd


def ref_lag_idx(feats, lag, n):
    """The reference matcher's best train index of the lag pairs
    (i - lag, i), followed from the program's features."""
    _, _, idx = G.top2(feats["desc"][lag:], feats["desc"][:n - lag], feats["valid"][:n - lag])
    return idx[..., None]
