"""Driver of the online navigation stream: the port's online pipeline
(`SlamPipeline.process_frame`, which publishes each frame: its pose read
and fused by the host EKF, a loop applied and the pose graph optimised)
fed one circuit walked again and again, a frame at a time.

The mix's circuit (one trajectory period at the mix's rate, the moving
panel with its own period, `render_frames` in all: the common period) is
rendered on the card from the seed and kept on the host; frame k is
rendered frame k mod render_frames, at time k / fps, with the IMU
samples of (t_{k-1}, t_k] of the same periodic stream. Set-up streams
one session from frame 0 until its first accepted loop (at most frame
`setup_max_frame`): the keyframe DB, the map and the pose graph built,
the graph's optimisation captured. The window continues that session,
one frame a unit; a session that would pass `session_nodes` nodes ends
and a new one starts at the next frame, inside the window.

The pipeline is built with its own `extractor=`, `matcher=`,
`detector=` and `sampler=` arguments, each the program's own function
wrapped to keep what it produced on the checked frames (every window
frame from the second to the `sample_span`-th that the window reaches);
no module is patched. Checked after the window, against
slam_bench/reference: the checked frames' ORB features, the detector's
raw outputs and dynamic mask, the match and the fused pose; the
optimised graph of each loop the seed drew against a plain LM started
from the same graph; every loop of the window against the ground truth;
and, on boxes drawn from the seed at the detector's shape, the
program's NMS against a plain greedy one.
"""

from __future__ import annotations

import dataclasses
import inspect

import numpy as np
import torch

from slam_bench.harness import inputs
from slam_bench.reference import compare, geometry as G, nms as ref_nms, pose_graph as ref_pg
from slam_bench.reference import precision
from slam_bench.scene import render


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfgj = run.cell.config
        self.tr = run.cell.traffic

    # ------------------------------------------------------------ set-up
    def setup(self):
        from aria_slam_tpu_torch.config import PipelineConfig
        from aria_slam_tpu_torch.models import detect, yolo
        from aria_slam_tpu_torch.ops import epipolar, match as match_ops, orb
        from aria_slam_tpu_torch.pipeline import slam_pipeline

        run, tr = self.run, self.tr
        dev = run.device
        self.slam_pipeline, self.epipolar = slam_pipeline, epipolar
        self.cfg = cfg = PipelineConfig.from_dict(self.cfgj["pipeline"])
        self.fps, self.n = tr["fps"], tr["render_frames"]
        self.frames, _, _, imu = inputs.scene(inputs.camera(self.cfgj), tr, run.seed, 0, self.n,
                                              dev)
        self.imu_ts, self.imu_acc, self.imu_gyr = imu
        self.hz = tr["imu_hz"]
        self.records, self.loops = [], []
        self._rec = None  # the record of the frame being stepped, when sampled
        # the program's components, wrapped to keep what they produce
        self.extract = lambda img: orb.extract(img, cfg.orb)
        self.match = lambda q, t: match_ops.match(q, t, cfg.matcher.ratio,
                                                  cfg.matcher.cross_check)
        det = cfg.detector
        self.weights = inputs.yolo_weights(dataclasses.asdict(det), run.seed, dev)
        self.model = yolo.make_model(det).to(dev)
        self.model.load_state_dict(self.weights)
        self.model.eval()
        self.model.register_forward_hook(self._det_hook)
        self.detect = detect.make_detector(det, model=self.model, device=dev)
        # a program without the `timer` argument (the parent of the change
        # that added it) runs untimed
        self.timed = "timer" in inspect.signature(slam_pipeline.SlamPipeline).parameters
        # every frame of the span, not a draw from it: RANSAC keeps another
        # hypothesis than the reference's in about half of this circuit's
        # frames, so the translation's first quartile over a dozen drawn
        # frames, or over those of them a slow window reached, lands on one
        # of those in some draws (PERF.md section 4)
        self.sample = set(range(1, tr["sample_span"]))
        r = inputs.rng(run.seed, 4)
        self.sample_loops = {int(i) for i in r.choice(tr["loop_span"], tr["sample_loops"],
                                                      replace=False)}
        self.k = 0          # the next frame's index
        self.sessions = 0
        self.window = None  # the window's first frame index once it starts
        self._new_session()
        while self.pipe.num_loops == 0:
            if self.k > tr["setup_max_frame"]:
                raise RuntimeError(f"no loop accepted by frame {tr['setup_max_frame']}")
            self.step()
        self.window = self.k

    def _new_session(self):
        run = self.run
        gen = torch.Generator(device=run.device)
        gen.manual_seed(inputs.sub_seed(run.seed, 5, self.sessions))
        self.sampler = self.epipolar.TorchSampler(gen)
        kw = dict(timer=run.spans) if self.timed and run.trace else {}
        self.pipe = self.slam_pipeline.SlamPipeline(
            self.cfg, device=run.device, extractor=self._extractor, matcher=self._matcher,
            detector=self._detector, sampler=self._sampler, lazy_depth=self.cfgj["lazy_depth"],
            **kw)
        self.session_start = self.k
        self.sessions += 1

    # ------------------------------------------------------------ wrappers
    def _extractor(self, img):
        feats = self.extract(img)
        if self._rec is not None:
            self._rec["raw"] = feats
        return feats

    def _matcher(self, q, t):
        m = self.match(q, t)
        if self._rec is not None:
            self._rec.update(q=q, t=t, m=m)
        return m

    def _detector(self, img):
        dets = self.detect(img)
        if self._rec is not None:
            self._rec["dets"] = dets
        return dets

    def _det_hook(self, module, args, out):
        if self._rec is not None:
            self._rec["det"] = out

    def _sampler(self, valid, num_hypotheses, sample_size, stage):
        idx = self.sampler(valid, num_hypotheses, sample_size, stage)
        if self._rec is not None and not stage.startswith("loop_"):
            self._rec["calls"].append((stage, valid, idx))
        return idx

    # ------------------------------------------------------------ window
    def _imu_range(self, k):
        """The first and last sample of frame k, numbered from 1 along the
        stream (sample s at s / imu_hz s): those in (t_{k-1}, t_k]."""
        def last(j):
            return int(np.floor(j * self.hz / self.fps + 1e-9)) if j >= 0 else 0
        return last(k - 1) + 1, last(k)

    def step(self) -> int:
        """One frame through process_frame, published, in the stage `chunk`
        (a chunk of one frame, which detect_forward_ms counts). -> 1."""
        with self.run.spans.stage("chunk"):
            self._frame()
        return 1

    def _frame(self):
        pipe = self.pipe
        if self.window is not None and pipe.state.frame_id + 2 > self.tr["session_nodes"]:
            self._new_session()
            pipe = self.pipe
        k = self.k
        ts = k / self.fps
        lo, hi = self._imu_range(k)
        m = len(self.imu_ts)
        for s in range(lo, hi + 1):
            j = (s - 1) % m
            pipe.process_imu(s / self.hz, self.imu_acc[j], self.imu_gyr[j])
        ordinal = None if self.window is None else k - self.window
        first = pipe.state.frame_id == 0
        rec = None
        if ordinal in self.sample and not first:
            rec = dict(k=k, calls=[], pose_prev=pipe.state.pose, prev_ts=pipe.state.prev_ts,
                       t0=pipe._t0, imu=(lo, hi))
        self._rec = rec
        g_prev, loops = pipe.state.graph, pipe.num_loops
        pipe.process_frame(self.frames[k % self.n], ts)
        self._rec = None
        out = pipe.last_output
        if rec is not None:
            rec.update(pose=out.pose, ok=out.vo_success, ninl=out.num_inliers)
            self.records.append(rec)
        if pipe.num_loops > loops and self.window is not None:
            j = len(self.loops)
            fid, q = pipe.loop_pairs[-1]
            loop = dict(pair=(self.session_start + fid, self.session_start + q))
            if j in self.sample_loops:
                node = pipe.state.frame_id
                pre = g_prev.node_pose.clone()
                pre[node] = out.pose
                loop.update(pre=pre, graph=pipe.state.graph)
            self.loops.append(loop)
        self.k += 1

    # ------------------------------------------------------------- check
    def gt(self, k):
        tr = self.tr
        return render.trajectory(np.asarray(k, np.float64) / self.fps, depth=tr["depth"],
                                 kind=tr["kind"], period=tr["period"])[0]

    def free(self):
        self.pipe = self.detect = self.model = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        if self.run.trace:
            self._least()
        self.free()
        return check_records(self, self.records)

    def _least(self):
        """Least times for the whole step's share: a launch of the corner
        and patch kernels at B = 1 (from four of the circuit's frames), and
        the window's match launches: N = 1 (the frame's match) and N = 8
        (the loop query's candidate scores) a frame, N = 5 a verify."""
        from slam_bench import counts
        from slam_bench.harness.bounds import extract_least_s

        info, cfg = self.run.info, self.cfg
        with precision.mode("fp32"):
            info["corner_least_s"], info["patch_least_s"] = extract_least_s(
                torch.from_numpy(self.frames[:4]).to(self.run.device),
                dataclasses.asdict(cfg.orb), 1)
        f = cfg.orb.num_features
        frames = self.k - self.window
        verifies = _counter("online.loop_queries")

        def match_least(launches):
            if verifies is None or launches != 2 * frames + verifies:
                return None
            return (frames * (counts.match_bound(1, f, f) + counts.match_bound(8, f, f))
                    + verifies * counts.match_bound(cfg.loop.top_k_candidates, f, f))

        det = cfg.detector
        info.update(match_least_s=match_least, extracts=frames, extract_frames=1, features=f,
                    detector=True, yolo_flops=counts.yolo_flops(
                        det.input_size, det.width_mult, det.depth_mult, det.num_classes))


def _counter(name):
    """The program's counter of the traced window, or None where the
    program keeps none."""
    from aria_slam_tpu_torch.utils import profiling

    if not hasattr(profiling, "recorded"):
        return None
    return profiling.recorded().counters.get(name)


def check_records(drv, records, control=None):
    """The numbers that decide `correct` (worst over the sample). control:
    None to judge the program's recorded outputs, or a precision ("tf32")
    to judge the reference computed in it in the program's place."""
    dev = drv.run.device
    cfg = drv.cfg
    K = torch.as_tensor(cfg.camera.K, device=dev)
    nums = dict(orb_kp_miss=0.0, orb_kp_rows=0, orb_desc_bits=0.0, orb_desc_rows=0,
                match_rows=0, det_gap=0.0, dyn_rows=0, dyn_share=0.0, dyn_ref_share=0.0)
    orb_cfg = dataclasses.asdict(cfg.orb)
    with precision.mode("fp32"):
        orb_ref = compare.Orb(orb_cfg, dev)
    prog_p, ref_p = [], []
    for rec in records:
        frame = torch.from_numpy(drv.frames[rec["k"] % drv.n]).to(dev)[None]
        with precision.mode("fp32"):
            ref_feats = orb_ref.extract(frame)
        raw = rec["raw"]
        feats = dict(xy=raw.xy[None], valid=raw.valid[None], desc=raw.desc[None],
                     angle=raw.angle[None], level=raw.octave[None])
        if control is not None:
            with precision.mode(control):
                feats = compare.Orb(orb_cfg, dev).extract(frame)
        kp, kp_rows, bits, rows = compare.orb_numbers(feats, ref_feats)
        nums["orb_kp_miss"] = max(nums["orb_kp_miss"], kp)
        nums["orb_kp_rows"] += kp_rows
        nums["orb_desc_bits"] = max(nums["orb_desc_bits"], bits)
        nums["orb_desc_rows"] += rows
        dyn = detector_check(drv, rec, frame, feats, control, nums)
        p, r, rows = pose_check(drv, rec, feats, dyn, K, control)
        nums["match_rows"] += rows
        prog_p.append(p)
        ref_p.append(r)
    if prog_p:
        cat = {k: torch.cat([p[k] for p in prog_p]) for k in prog_p[0]}
        rcat = {k: torch.cat([r[k] for r in ref_p]) for k in ref_p[0]}
        live = torch.ones_like(cat["ok"])
        nums.update({"pose_" + k: v for k, v in compare.pose_numbers(
            cat, rcat, live, torch.zeros_like(cat["ninl"])).items()})
    nums["pg_gap"], nums["pg_rot_deg"], nums["sampled_loops"] = graph_check(drv, control)
    nums["nms_rows"], nums["nms_kept"] = nms_check(drv, control)
    pairs = [lp["pair"] for lp in drv.loops]
    gt = {k: drv.gt(k) for pair in pairs for k in pair}
    nums["loop_precision"], nums["loops_min"] = compare.loop_precision(pairs, gt)
    nums["sampled_frames"] = len(prog_p)
    nums["window_frames"] = drv.k - drv.window
    return nums


def detector_check(drv, rec, frame, feats, control, nums):
    """YOLO in float32 on the frame with the same weights: the gap of the
    raw outputs, and the program's dynamic-object mask of its keypoints
    (from the boxes its NMS kept) against the one decoded from the
    reference's outputs. -> the mask of the program's matched keypoints
    that the pose check follows: the program's, or the control's own."""
    from slam_bench.reference import yolo as ry

    det = drv.cfg.detector
    h, w = frame.shape[-2:]
    with precision.mode("fp32"):
        x = ry.preprocess(frame, det.input_size)
        ref_out = ry.forward(drv.weights, x, det.width_mult, det.depth_mult, det.num_classes)
        prog_out, dyn = rec["det"], boxes_mask(feats["xy"][0], rec["dets"])[None]
        cur = boxes_mask(rec["q"].xy, rec["dets"])
        if control is not None:
            prog_out = ry.forward(drv.weights, x, det.width_mult, det.depth_mult,
                                  det.num_classes, quant=precision.fp8)
            dyn, cur = (compare.dynamic_mask(xy[None], prog_out, det.input_size, h, w,
                                             det.conf_threshold, det.max_detections)
                        for xy in (feats["xy"][0], rec["q"].xy))
            cur = cur[0]
        nums["det_gap"] = max(nums["det_gap"], compare.detector_gap(prog_out, ref_out))
        rows, share, ref_share = compare.dynamic_rows(
            dyn, feats["xy"], feats["valid"], ref_out, det.input_size, h, w,
            det.conf_threshold, det.max_detections)
    nums["dyn_rows"] += rows
    nums["dyn_share"] = max(nums["dyn_share"], share)
    nums["dyn_ref_share"] = max(nums["dyn_ref_share"], ref_share)
    return cur


def boxes_mask(xy, dets):
    """(K,) bool: the keypoints xy (K, 2) inside a kept box of a dynamic
    class among the program's Detections."""
    dyn = torch.zeros(dets.classes.shape, dtype=torch.bool, device=xy.device)
    for c in compare.DYNAMIC_CLASSES:
        dyn |= dets.classes.long() == c
    b = dets.boxes[dets.valid & dyn]
    x, y = xy[:, None, 0], xy[:, None, 1]
    return ((x >= b[:, 0]) & (x <= b[:, 2]) & (y >= b[:, 1]) & (y <= b[:, 3])).any(-1)


def gyro_window(drv, rec):
    """The gyro's rotation over the frame's IMU window as the program was
    handed it: the samples' times relative to the session's first frame,
    in float32, composed in float64 from the previous frame's time, each
    step's dt within [0, 0.05] s; in the pose change's convention (the
    transpose). -> (R (3, 3) float32, has_gyro)."""
    lo, hi = rec["imu"]
    m = len(drv.imu_ts)
    idx = [(s - 1) % m for s in range(lo, hi + 1)]
    ts = np.array([np.float32(s / drv.hz - rec["t0"]) for s in range(lo, hi + 1)],
                  np.float64)[-drv.cfg.ekf.imu_window:]
    gyr = drv.imu_gyr[idx][-drv.cfg.ekf.imu_window:].astype(np.float32).astype(np.float64)
    R_ci = np.asarray(drv.cfg.imu_cam_rotation, np.float64)
    D, t = np.eye(3), float(rec["prev_ts"])
    for tt, g in zip(ts, gyr):
        D = D @ G._exp_so3(g * float(np.clip(tt - t, 0.0, 0.05)))
        t = tt
    return (R_ci @ D @ R_ci.T).T.astype(np.float32), len(ts) >= 2


def pose_check(drv, rec, feats, dyn, K, control):
    """The frame's match and fused pose: the reference's matcher and pose
    solver followed from the program's features of the previous and this
    frame, the dynamic mask and the RANSAC draws, with the gyro's
    rotation from the IMU window the program was handed; against the
    pose change the program published (its pose after the frame against
    its pose before, in float64: R, the direction of t, |t| its pin) ->
    (prog, ref, match rows)."""
    dev = K.device
    q, t, m = rec["q"], rec["t"], rec["m"]
    fe = dict(xy=torch.stack([t.xy, q.xy]), valid=torch.stack([t.valid, q.valid]),
              desc=torch.stack([t.desc, q.desc]))
    pairs = (torch.tensor([0], device=dev), torch.tensor([1], device=dev))
    draws = {stage: idx[None] for stage, _, idx in rec["calls"]}
    Rg, okg = gyro_window(drv, rec)
    Rg = torch.from_numpy(Rg).to(dev)[None]
    okg = torch.tensor([okg], device=dev)
    cfg = drv.cfg
    ransac = dataclasses.asdict(cfg.ransac)

    def rule(p_, c_, idx, gate):
        return gate & ~dyn[None]

    def solve(mode):
        with precision.mode(mode):
            return compare.front_end(fe, pairs, rule, K, ransac, draws, Rg, okg,
                                     cfg.matcher.ratio, cfg.vo_scene_depth)

    ref = solve("fp32")
    if control is None:
        prog_valid = rec["calls"][0][1]
        rows = int((prog_valid != ref["valid"][0]).sum())
        rows += int(((m.train_idx.long() != ref["best_idx"][0]) & q.valid).sum())
        T0 = rec["pose_prev"].double().cpu()
        T1 = rec["pose"].double().cpu()
        rel = torch.linalg.inv(T0) @ T1
        R = rel[:3, :3].T
        tv = -(R @ rel[:3, 3])
        ok = rec["ok"].reshape(1).cpu()
        prog = dict(R=R[None].float(), t=(tv / tv.norm().clamp(min=1e-300))[None].float(),
                    ok=ok, ninl=rec["ninl"].reshape(1).cpu(), pin=tv.norm()[None].float(),
                    pin_ok=ok)
        prog = {k: v.to(dev) for k, v in prog.items()}
    else:
        alt = solve(control)
        rows = int((alt["valid"] != ref["valid"]).sum())
        prog = {k: alt[k] for k in ("R", "t", "ok", "ninl", "pin", "pin_ok")}
    refd = {k: ref[k] for k in ("R", "t", "ok", "ninl", "pin", "pin_ok")}
    # the program publishes a pose change only where its VO succeeded: its
    # rotation is compared there
    refd["gyro_ok"] = okg & prog["ok"]
    return prog, refd, rows


def graph_check(drv, control):
    """Each sampled loop's optimised graph against the plain LM from the
    same graph (its live nodes and valid edges; the loop edge, the last,
    at the configuration's loop weight): the largest distance (m) between
    a node's optimised positions and the largest angle (degrees) between
    its rotations -> (gap, rotation gap, loops checked)."""
    cfg = drv.cfg.pose_graph
    gap, rot, n = 0.0, 0.0, 0
    for lp in drv.loops:
        if "pre" not in lp:
            continue
        g = lp["graph"]
        nn, ne = int(g.num_nodes), int(g.num_edges)
        w = (g.edge_weight[:ne] * g.edge_valid[:ne].float()).clone()
        w[ne - 1] = cfg.loop_edge_weight
        args = (lp["pre"][:nn], g.node_valid[:nn], g.edge_i[:ne], g.edge_j[:ne],
                g.edge_rel[:ne], w, g.edge_twt[:ne], g.edge_rwt[:ne], cfg.lm_iterations,
                cfg.cg_iterations, cfg.init_lambda)
        with precision.mode("fp32"):
            ref = ref_pg.optimize(*args)
        if control is None:
            prog = g.node_pose[:nn]
        else:
            with precision.mode(control):
                prog = ref_pg.optimize(*args)
        gap = max(gap, float((prog[:, :3, 3] - ref[:, :3, 3]).norm(dim=-1).max()))
        rot = max(rot, float(G.rotation_deg(prog[:, :3, :3], ref[:, :3, :3]).max()))
        n += 1
    return gap, rot, n


def nms_check(drv, control):
    """The program's NMS (ops/boxes.nms) against the plain greedy one on
    `nms_boxes` overlapping boxes drawn from the seed in the detector's
    input square -> (keep masks' differing rows, boxes the reference
    kept)."""
    from aria_slam_tpu_torch.ops import boxes

    det = drv.cfg.detector
    dev = drv.run.device
    b, s, v = (torch.from_numpy(x).to(dev) for x in ref_nms.draw(
        inputs.rng(drv.run.seed, 6), drv.tr["nms_boxes"], det.input_size))
    with precision.mode("fp32"):
        ref = ref_nms.greedy(b, s, v, det.nms_iou_threshold)
    if control is None:
        prog = boxes.nms(b, s, v, det.nms_iou_threshold)
    else:
        with precision.mode(control):
            prog = ref_nms.greedy(b, s, v, det.nms_iou_threshold)
    return int((prog != ref).sum()), int(ref.sum())
