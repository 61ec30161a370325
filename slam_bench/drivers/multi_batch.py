"""Driver of S sequences in lockstep rounds through one batched front end
(`multi_eval.make_multi_chunk_frontend` with `fetch_many`), as
`multi_eval.run_scenes` runs them, with the frames in host memory.

Each sequence has its own scene, drawn from (seed, slot), with `cycle`
distinct frames, and its own RANSAC stream; a sweep of that period returns to its first
frame, so the stream cycles through them with timestamps that keep
rising. A unit of the window is one round: S x (C + 1) frames extracted,
S x C pairs matched and solved, then the round's host chain (copied from
`run_scenes`), with the gyro priors of `fusion/gyro_prior`.

Checked after the window: rounds drawn from the seed, each against the
reference (ORB of every frame, the matcher's best indices and
correspondence masks, the gyro's pair rotations, the fused pose and
pins of every pair), and each sequence's chained trajectory over its
first `ate_frames` frames against the ground truth.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from slam_bench.harness import inputs
from slam_bench.reference import compare, geometry as G, precision
from slam_bench.scene import render

# rounds of the window checked against the reference, drawn from the seed
# among its first SAMPLE_FROM rounds
SAMPLE, SAMPLE_FROM = 2, 6


class Driver:
    def __init__(self, run):
        self.run = run
        self.cfgj = run.cell.config
        self.tr = run.cell.traffic

    def setup(self):
        from aria_slam_tpu_torch.config import PipelineConfig
        from aria_slam_tpu_torch.eval import multi_eval

        run, tr = self.run, self.tr
        dev = run.device
        self.me = multi_eval
        self.cfg = PipelineConfig.from_dict(self.cfgj["pipeline"])
        self.chunk, self.s = self.cfgj["chunk"], self.cfgj["sequences"]
        self.cycle = tr["cycle"]
        cam = inputs.camera(self.cfgj)
        scenes = [inputs.scene(cam, tr, run.seed, q, self.cycle, dev) for q in range(self.s)]
        self.frames = np.stack([sc[0] for sc in scenes])      # (S, cycle, H, W)
        self.imus = [sc[3] for sc in scenes]
        self.fps = tr["fps"]
        self.frontend = multi_eval.make_multi_chunk_frontend(self.cfg)
        self.sampler = multi_eval.SequenceSampler(
            [torch.Generator(device=dev).manual_seed(inputs.sub_seed(run.seed, 5, q))
             for q in range(self.s)])
        self._orig_extract = multi_eval.extract
        multi_eval.extract = self._extract
        self._orig_match = multi_eval.match_ops.match_batched
        multi_eval.match_ops.match_batched = self._match
        self.records, self._record = [], False
        r = inputs.rng(run.seed, 4)
        self.sample = {int(x) for x in r.choice(SAMPLE_FROM, SAMPLE, replace=False)}
        self.rnd = 0
        self._restart()
        self.step()  # warm-up: one round of the cell's shapes
        self.rnd = 0
        self._restart()
        self.run.info.update(extract_frames=self.s * (self.chunk + 1),
                             features=self.cfg.orb.num_features, detector=False)

    def _restart(self):
        self.T = [np.eye(4, dtype=np.float32) for _ in range(self.s)]
        self.traj = [[np.eye(4, dtype=np.float32)] for _ in range(self.s)]

    def _extract(self, frames, cfg):
        feats = self._orig_extract(frames, cfg)
        if self._record:
            self.records[-1]["feats"] = dict(xy=feats.xy, valid=feats.valid, desc=feats.desc,
                                             angle=feats.angle,
                                             level=feats.octave)
        return feats

    def _match(self, query, train, ratio):
        m = self._orig_match(query, train, ratio)
        if self._record:
            self.records[-1]["train_idx"] = m.train_idx
        return m

    def step(self) -> int:
        from aria_slam_tpu_torch.fusion import gyro_prior
        from aria_slam_tpu_torch.pipeline.slam_pipeline import fetch_many

        spans, c, s = self.run.spans, self.chunk, self.s
        k0 = self.rnd * c
        idx = (k0 + np.arange(c + 1)) % self.cycle
        # IMU time of the round: the stream is periodic in `cycle` frames
        ts = (k0 % self.cycle + np.arange(c + 1)) / self.fps
        self._record = self.rnd in self.sample
        sampler = self.sampler
        if self._record:
            sampler = inputs.RecordingSampler(self.sampler)
            self.records.append(dict(rnd=self.rnd, idx=idx, ts=ts))
        with spans.stage("round"):
            frames = self.frames[:, idx]
            with spans.stage("chain"):
                gRs = np.empty((s, c, 3, 3), np.float32)
                goks = np.empty((s, c), bool)
                for q in range(s):
                    imu = self.imus[q]
                    gRs[q], goks[q] = gyro_prior.pair_rotations(imu[0], imu[2], ts)
            with spans.stage("batch_frontend"):
                dev = self.run.device
                gR, gok = torch.from_numpy(gRs).to(dev), torch.from_numpy(goks).to(dev)
                out = self.frontend(torch.from_numpy(frames).to(dev), sampler, gR, gok)
                R, t, ok, pins, pin_oks = fetch_many(out)
            with spans.stage("chain"):
                for q in range(s):
                    for i in range(c):
                        Tcp = np.eye(4, dtype=np.float32)
                        if ok[q, i] or goks[q, i]:
                            Tcp[:3, :3] = R[q, i] if ok[q, i] else gRs[q, i]
                            if ok[q, i] and pin_oks[q, i]:
                                Tcp[:3, 3] = t[q, i] * pins[q, i]
                        self.T[q] = self.T[q] @ np.linalg.inv(Tcp).astype(np.float32)
                        self.traj[q].append(self.T[q].copy())
        if self._record:
            self.records[-1].update(calls=sampler.calls, out=[x for x in out])
            self._record = False
        self.rnd += 1
        return s * c

    def free(self):
        self.me.extract = self._orig_extract
        self.me.match_ops.match_batched = self._orig_match
        self.frontend = None
        if self.run.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> dict:
        self.free()
        if self.run.trace:
            self._least()
        return check_records(self, self.records)

    def _least(self):
        """Per-launch least times for the roofline readers, from four of
        the cell's frames."""
        from slam_bench import counts
        from slam_bench.harness.bounds import extract_least_s

        info, cfg = self.run.info, self.cfg
        with precision.mode("fp32"):
            info["corner_least_s"], info["patch_least_s"] = extract_least_s(
                torch.from_numpy(self.frames[:4, 0]).to(self.run.device),
                dataclasses.asdict(cfg.orb), self.s * (self.chunk + 1))
        f, pairs = cfg.orb.num_features, self.s * self.chunk
        info["match_least_s"] = lambda launches: launches * counts.match_bound(pairs, f, f)
        info["extracts"] = len(self.run.steps)


def check_records(drv, records, control=None):
    """The numbers that decide `correct` (worst over the sample); control:
    a precision in which the reference stands in the program's place."""
    dev = drv.run.device
    cfg = drv.cfg
    K = torch.as_tensor(cfg.camera.K, device=dev)
    orb_cfg = dataclasses.asdict(cfg.orb)
    ransac = dataclasses.asdict(cfg.ransac)
    c, s = drv.chunk, drv.s
    nums = dict(orb_kp_miss=0.0, orb_kp_rows=0, orb_desc_bits=0.0, orb_desc_rows=0, match_rows=0)
    with precision.mode("fp32"):
        orb_ref = compare.Orb(orb_cfg, dev)
    progs, refs = [], []
    for rec in records:
        if "out" not in rec:
            continue
        frames = torch.from_numpy(drv.frames[:, rec["idx"]].reshape(
            (s * (c + 1),) + drv.frames.shape[2:])).to(dev)
        with precision.mode("fp32"):
            parts = [orb_ref.extract(frames[i:i + c + 1]) for i in range(0, len(frames), c + 1)]
        ref_feats = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        feats = rec["feats"]
        if control is not None:
            with precision.mode(control):
                alt = compare.Orb(orb_cfg, dev)
                parts = [alt.extract(frames[i:i + c + 1]) for i in range(0, len(frames), c + 1)]
            feats = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
        kp, kp_rows, bits, rows = compare.orb_numbers(feats, ref_feats)
        nums["orb_kp_miss"] = max(nums["orb_kp_miss"], kp)
        nums["orb_kp_rows"] += kp_rows
        nums["orb_desc_bits"] = max(nums["orb_desc_bits"], bits)
        nums["orb_desc_rows"] += rows
        base = torch.arange(s, device=dev)[:, None] * (c + 1)
        pi = (base + torch.arange(c, device=dev)).reshape(-1)
        ci = pi + 1
        fv = feats["valid"]

        def rule(p_, c_, idx, gate):
            return gate & torch.take_along_dim(fv[p_], idx, 1)

        draws = {stage: idx for stage, _, idx in rec["calls"]}
        gyro = [G.gyro_pairs(imu[0], imu[2], rec["ts"]) for imu in drv.imus]
        gR = torch.from_numpy(np.concatenate([g[0] for g in gyro])).to(dev)
        gok = torch.from_numpy(np.concatenate([g[1] for g in gyro])).to(dev)
        args = (feats, (pi, ci), rule, K, ransac, draws, gR, gok, cfg.matcher.ratio,
                cfg.vo_scene_depth)
        with precision.mode("fp32"):
            ref = compare.front_end(*args)
        if control is None:
            R, t, ok, pins, pin_oks = (x.reshape((s * c,) + x.shape[2:]) for x in rec["out"])
            prog = dict(R=R, t=t, ok=ok, pin=pins, pin_ok=pin_oks, ninl=ref["ninl"])
            nums["match_rows"] += int((rec["calls"][0][1] != ref["valid"]).sum())
            nums["match_rows"] += int(((rec["train_idx"].long() != ref["best_idx"])
                                       & fv[ci]).sum())
        else:
            with precision.mode(control):
                alt = compare.front_end(*args)
            prog = {k: alt[k] for k in ("R", "t", "ok", "pin", "pin_ok", "ninl")}
            nums["match_rows"] += int((alt["valid"] != ref["valid"]).sum())
        prog["has_ninl"] = torch.zeros_like(prog["ok"])
        progs.append(prog)
        refs.append({k: ref[k] for k in ("R", "t", "ok", "ninl", "pin", "pin_ok")})
        refs[-1]["gyro_ok"] = gok
    if progs:
        cat = {k: torch.cat([p[k] for p in progs]) for k in progs[0]}
        rcat = {k: torch.cat([r[k] for r in refs]) for k in refs[0]}
        live = torch.ones_like(cat["ok"])
        # a group is a batch slot: its pairs of every sampled round
        slot = torch.arange(s, device=dev).repeat_interleave(c).repeat(len(progs))
        nums.update({"pose_" + k: v for k, v in
                     compare.pose_numbers(cat, rcat, live, slot).items() if k != "inl_gap_p50"})
    n_ate = drv.tr["ate_frames"]
    if drv.rnd * c + 1 >= n_ate:
        gt, _ = render.trajectory((np.arange(n_ate) % drv.cycle) / drv.fps,
                                  depth=drv.tr["depth"], kind=drv.tr["kind"],
                                  period=drv.tr["period"])
        nums["ate_m"] = max(compare.umeyama_ate(np.stack([T[:3, 3] for T in tr[:n_ate]]), gt)
                            for tr in drv.traj)
    nums["sampled_rounds"] = sum(1 for r in records if "out" in r)
    return nums
