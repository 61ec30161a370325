#!/usr/bin/env python3
"""Where a sequence's front-end results start to depend on its batch: the
multi-sequence front end (eval/multi_eval.py) run on S sequences in one
batch and on each sequence alone, compared stage by stage.

Run from the repository root:

    python3 tools/multi_batch_diff.py [--sequences 4] [--chunk 16]
        [--device cpu] [--small]

Writes S synthetic sweeps of one chunk round (C+1 frames, 752x480, the
periods and seeds of chip_smoke.py's multi phase; --small: 320x240 with
the light configuration of the CPU tests) into a temporary directory and
runs the round's front end both ways, on the card unless --device says
otherwise. Each stage after the first is fed the SAME inputs both ways
(the per-sequence results of the stage before, concatenated for the
batch), so a difference printed for a stage is made by that stage at the
other batch size:

  pyramid     ops/pyramid.build_pyramid at B = S(C+1) against B = C+1
  extract     eval/chunked.extract (ORB, undistortion)
  match       ops/match.match_batched at N = S*C against N = C
  essential   ops/epipolar.estimate_relative_pose, per-sequence generators
  gyro_t      ops/epipolar.translation_given_rotation under the gyro prior
  pins        ops/epipolar.pin_depths + pin_scale
  frontend    the whole front end, as run_scenes calls it

Prints one line a stage: the largest difference of each output and how
many of its elements differ.

Then it runs the gyro-fused RANSAC and the pins on the whole batch under
a torch function mode that keeps every op's call, re-runs each op on the
first sequence's rows of its arguments, and prints each line of the port
where that differs from the same rows of the op's batched result: the
ops whose rounding depends on the batch size, each found whether or not
an earlier one already changed its inputs. On the card it last times the
batched front end with the short contractions of ops/linalg.py and of
the Sampson polish (ops/epipolar._apply) as they run there (a product
and a sum) and as the batched GEMMs they replaced.
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

PERIODS = (10.0, 12.0, 14.0, 16.0, 18.0, 20.0, 22.0, 24.0)


def diff(a, b) -> str:
    """'max |a - b| (n of m differ)' for two tensors of one shape."""
    import torch

    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype == torch.bool:
        a, b = a.int(), b.int()
    d = (a.double() - b.double()).abs()
    d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    return f"{float(d.max()):.3g} ({int((d > 0).sum())} of {d.numel()} differ)"


class _Recorder:
    """A torch function mode that keeps a copy of every op's call (the
    function, its arguments, its outputs) and the innermost line of the
    port that made it."""

    def __init__(self):
        from torch.overrides import TorchFunctionMode

        rec = self

        class Mode(TorchFunctionMode):
            def __torch_function__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                rec.add(func, args, kwargs or {}, out)
                return out

        self.mode, self.ops, self.nbytes = Mode(), [], 0

    @staticmethod
    def where() -> str:
        import traceback

        for fr in reversed(traceback.extract_stack()[:-3]):
            if "aria_slam_tpu_torch" in fr.filename:
                return f"{fr.filename.split('aria_slam_tpu_torch/')[-1]}:{fr.lineno} {fr.line}"
        return "?"

    def add(self, func, args, kwargs, out):
        import torch
        from torch.utils._pytree import tree_flatten, tree_map

        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if not outs:
            return
        # copies: later in-place writes must not reach them
        keep = tree_map(lambda x: _copy(x) if isinstance(x, torch.Tensor) else x,
                        (args, kwargs, outs))
        self.nbytes += sum(t.numel() * t.element_size() for t in tree_flatten(keep)[0]
                           if isinstance(t, torch.Tensor))
        self.ops.append((func, self.where()) + keep)


def check_ops(rec: _Recorder, batch: int, lo: int, hi: int) -> None:
    """Re-run every recorded op on rows lo:hi of each argument whose
    leading axis is the batch's, and print each line of the port where
    an op's result on those rows differs from rows lo:hi of its result on
    the whole batch: the ops whose rounding depends on the batch size."""
    import torch
    from torch.utils._pytree import tree_flatten, tree_map

    def rows(x):
        if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == batch:
            return _copy(x[lo:hi])
        return x

    def equal(a, b):
        return bool(torch.equal(a, b) or (
            a.is_floating_point() and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))))

    sites, checked = {}, 0
    for i, (func, site, args, kwargs, outs) in enumerate(rec.ops):
        if not any(isinstance(t, torch.Tensor) and t.dim() and t.shape[0] == batch
                   for t in tree_flatten((args, kwargs))[0]):
            continue
        try:
            got = func(*tree_map(rows, args), **tree_map(rows, kwargs))
        except Exception:
            continue  # an argument that names the batch's size (a shape)
        got = [t for t in tree_flatten(got)[0] if isinstance(t, torch.Tensor)]
        pairs = [(g, o[lo:hi]) for g, o in zip(got, outs)
                 if o.dim() and o.shape[0] == batch]
        if not pairs or len(got) != len(outs) or any(g.shape != o.shape for g, o in pairs):
            continue  # the call named the batch's size (a shape, an expand)
        checked += 1
        bad = [(g, o) for g, o in pairs if not equal(g, o)]
        if bad:
            d = max(float((g.double() - o.double()).abs().nan_to_num(float("inf")).max())
                    for g, o in bad)
            name = getattr(func, "__name__", str(func))
            first, n, dmax = sites.get(site, (i, 0, 0.0))
            sites[site] = (first, n + 1, max(dmax, d))
            sites[site + " "] = name
    print(f"ops: {len(rec.ops)} recorded ({rec.nbytes / 2**30:.2f} GiB kept), {checked} "
          f"checked on rows {lo}:{hi} of {batch}; batch-dependent at "
          f"{sum(1 for k in sites if not k.endswith(' '))} lines", flush=True)
    for site, v in sorted(((k, v) for k, v in sites.items() if not k.endswith(" ")),
                          key=lambda kv: kv[1][0]):
        print(f"  op {v[0]} {sites[site + ' ']} at {site}: {v[1]} calls differ, "
              f"max {v[2]:.3g}", flush=True)


def _copy(x):
    """A copy of tensor x with its strides (a reduction's order can depend
    on its input's layout); a plain copy where x overlaps itself."""
    import torch

    x = x.detach()
    try:
        return torch.empty_strided(x.size(), x.stride(), dtype=x.dtype,
                                   device=x.device).copy_(x)
    except RuntimeError:
        return x.clone()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sequences", type=int, default=4)
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="320x240 and the CPU tests' light configuration")
    args = ap.parse_args()

    import torch

    from aria_slam_tpu_torch.config import (
        CameraConfig, OrbConfig, PipelineConfig, RansacConfig,
    )
    from aria_slam_tpu_torch.eval import multi_eval
    from aria_slam_tpu_torch.eval.chunked import extract
    from aria_slam_tpu_torch.fusion import gyro_prior
    from aria_slam_tpu_torch.io import euroc, synthetic_scene
    from aria_slam_tpu_torch.ops import epipolar, match as match_ops, pyramid

    dev = torch.device(args.device)
    s, c = args.sequences, args.chunk
    cam = CameraConfig(k1=0.0, k2=0.0, p1=0.0, p2=0.0)
    cfg = PipelineConfig(enable_loop_closure=False, enable_mapping=False, enable_fusion=False,
                         enable_detection=False)
    if args.small:
        cam = CameraConfig(width=320, height=240, fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                           k1=0.0, k2=0.0, p1=0.0, p2=0.0)
        cfg = dataclasses.replace(cfg, orb=OrbConfig(num_features=384, num_levels=3),
                                  ransac=RansacConfig(num_hypotheses=128))
    with tempfile.TemporaryDirectory(prefix="multi_batch_diff_") as tmp:
        datas = [euroc.load(synthetic_scene.generate(
            f"{tmp}/seq{q}", num_frames=c + 1, fps=10.0, cam=cam, depth=4.0, traj="sweep",
            period=PERIODS[q % len(PERIODS)], seed=q)) for q in range(s)]
        frames = np.stack([np.stack([euroc.load_image(p) for p in d.image_paths])
                           for d in datas])
    cfg = dataclasses.replace(cfg, camera=datas[0].camera)
    gyro = [gyro_prior.pair_rotations(d.imu_ts, d.imu_gyro, d.image_ts, R_cam_imu=d.R_cam_imu)
            for d in datas]
    gR = torch.from_numpy(np.stack([g[0] for g in gyro])).to(dev)
    gok = torch.from_numpy(np.stack([g[1] for g in gyro])).to(dev)
    K = torch.as_tensor(cfg.camera.K, dtype=torch.float32, device=dev)
    focal = 0.5 * (cfg.camera.fx + cfg.camera.fy)
    in_thresh_sq = (cfg.ransac.inlier_threshold_px / focal) ** 2
    fr = torch.from_numpy(frames).to(dev)
    print(f"{s} sequences x {c + 1} frames at {cam.width}x{cam.height} on {dev}"
          + (f" ({torch.cuda.get_device_name(dev)})" if dev.type == "cuda" else ""), flush=True)

    def gens():
        return [torch.Generator(device=dev).manual_seed(multi_eval.sequence_seed(0, q))
                for q in range(s)]

    def both(name, names, batched, alone):
        """batched() -> outputs for all S sequences (leading axis S * n);
        alone(q) -> the outputs of sequence q by itself."""
        out_b = batched()
        out_a = [torch.cat(xs) for xs in zip(*(alone(q) for q in range(s)))]
        print(f"{name:10s} " + "; ".join(f"{k} {diff(x, y)}"
                                         for k, x, y in zip(names, out_b, out_a)), flush=True)

    # pyramid: every level
    flat = fr.reshape(s * (c + 1), *fr.shape[2:]).float()
    levels = [f"level{i}" for i in range(cfg.orb.num_levels)]
    both("pyramid", levels,
         lambda: tuple(pyramid.build_pyramid(flat, cfg.orb.num_levels, cfg.orb.scale_factor)),
         lambda q: tuple(pyramid.build_pyramid(fr[q].float(), cfg.orb.num_levels,
                                               cfg.orb.scale_factor)))
    fields = ("xy", "angle", "desc", "valid", "response")

    def feats_tuple(f):
        return tuple(getattr(f, k) for k in fields)

    feats_alone = [extract(fr[q], cfg) for q in range(s)]
    both("extract", fields,
         lambda: feats_tuple(extract(fr.reshape(s * (c + 1), *fr.shape[2:]), cfg)),
         lambda q: feats_tuple(feats_alone[q]))
    # later stages on the per-sequence features, concatenated for the batch
    feats = type(feats_alone[0])(**{k.name: torch.cat([getattr(f, k.name) for f in feats_alone])
                                    for k in dataclasses.fields(feats_alone[0])})

    def pair_split(f, n):
        f = f.map(lambda x: x.reshape(n, c + 1, *x.shape[1:]))
        return (f.map(lambda x: x[:, :-1].reshape(n * c, *x.shape[2:])),
                f.map(lambda x: x[:, 1:].reshape(n * c, *x.shape[2:])))

    prev_b, cur_b = pair_split(feats, s)
    pc_alone = [pair_split(f, 1) for f in feats_alone]
    m_alone = [match_ops.match_batched(cu, pr, cfg.matcher.ratio) for pr, cu in pc_alone]
    both("match", ("train_idx", "valid"), lambda: (lambda m: (m.train_idx, m.valid))(
         match_ops.match_batched(cur_b, prev_b, cfg.matcher.ratio)),
         lambda q: (m_alone[q].train_idx, m_alone[q].valid))

    def corr(pr, cu, m):
        tidx = m.train_idx.long()
        return (torch.take_along_dim(pr.xy, tidx[..., None], 1), cu.xy,
                m.valid & torch.take_along_dim(pr.valid, tidx, 1))

    corr_alone = [corr(pr, cu, m) for (pr, cu), m in zip(pc_alone, m_alone)]
    xp, xc, va = (torch.cat(xs) for xs in zip(*corr_alone))

    def ess_fields(d):
        return d.R, d.t, d.success, d.num_inliers, d.inlier_mask

    both("essential", ("R", "t", "success", "num_inliers", "inlier_mask"),
         lambda: ess_fields(epipolar.estimate_relative_pose(
             xp, xc, va, K, cfg.ransac, multi_eval.SequenceSampler(gens()))),
         lambda q: ess_fields(epipolar.estimate_relative_pose(
             *corr_alone[q], K, cfg.ransac, multi_eval.SequenceSampler(gens()[q:q + 1]))))
    ess_alone = [epipolar.estimate_relative_pose(*corr_alone[q], K, cfg.ransac,
                                                 multi_eval.SequenceSampler(gens()[q:q + 1]))
                 for q in range(s)]
    w = torch.cat([d.inlier_mask for d in ess_alone]).float()

    def tgr(xp_, xc_, va_, w_, R_):
        return epipolar.translation_given_rotation(
            R_, epipolar.normalize_points(xp_, K), epipolar.normalize_points(xc_, K), w_,
            thresh_sq=in_thresh_sq, valid=va_)

    both("gyro_t", ("t", "inlier_mask"), lambda: tgr(xp, xc, va, w, gR.reshape(s * c, 3, 3)),
         lambda q: tgr(*corr_alone[q], ess_alone[q].inlier_mask.float(), gR[q]))

    # pins on the same poses
    fused_alone = [epipolar.estimate_pose_gyro_fused(
        *corr_alone[q], K, cfg.ransac, multi_eval.SequenceSampler(gens()[q:q + 1]), gR[q],
        gok[q], in_thresh_sq) for q in range(s)]
    fused = type(fused_alone[0])(**{k.name: torch.cat([getattr(d, k.name) for d in fused_alone])
                                    for k in dataclasses.fields(fused_alone[0])})

    def pins(d, xp_, xc_, va_):
        pz, pg = epipolar.pin_depths(d, xp_, xc_, va_, K, cfg.vo_pin_estimator,
                                     cfg.vo_pin_sigma_px)
        return (pz, pg) + tuple(epipolar.pin_scale(pz, pg, cfg.vo_scene_depth))

    both("pins", ("z", "good", "pin", "pin_ok"), lambda: pins(fused, xp, xc, va),
         lambda q: pins(fused_alone[q], *corr_alone[q]))

    # which ops of the RANSAC and the pins round differently in another
    # batch: the samples drawn beforehand (the draws are per sequence)
    class Fixed:
        def __init__(self, by_stage):
            self.by_stage = by_stage

        def __call__(self, valid, num_hypotheses, sample_size, stage):
            return self.by_stage[stage]

    draws = []
    for q in range(s):
        smp = multi_eval.SequenceSampler(gens()[q:q + 1])
        draws.append({st: smp(corr_alone[q][2], h, n, st) for st, h, n in (
            ("essential", cfg.ransac.num_hypotheses, cfg.ransac.sample_size),
            ("homography", cfg.ransac.h_hypotheses, 4))})
    fixed = Fixed({st: torch.cat([d[st] for d in draws]) for st in draws[0]})
    rec = _Recorder()
    with rec.mode:
        d = epipolar.estimate_pose_gyro_fused(xp, xc, va, K, cfg.ransac, fixed,
                                              gR.reshape(s * c, 3, 3), gok.reshape(s * c),
                                              in_thresh_sq)
        pins(d, xp, xc, va)
    check_ops(rec, s * c, 0, c)
    del rec

    # the whole front end, as run_scenes calls it
    frontend = multi_eval.make_multi_chunk_frontend(cfg)
    both("frontend", ("R", "t", "ok", "pin", "pin_ok"),
         lambda: tuple(x.reshape(s * c, *x.shape[2:]) for x in frontend(
             fr, multi_eval.SequenceSampler(gens()), gR, gok)),
         lambda q: tuple(x[0] for x in frontend(fr[q:q + 1], multi_eval.SequenceSampler(
             gens()[q:q + 1]), gR[q:q + 1], gok[q:q + 1])))
    if dev.type == "cuda":
        time_forms(frontend, fr, gens, gR, gok)
    return 0


def time_forms(frontend, fr, gens, gR, gok, reps: int = 6) -> None:
    """The batched front end's time (host clock around a synchronised
    call, median of `reps`) with the short contractions as a product and
    a sum (what the card runs) and as einsum / matmul (the batched GEMMs
    they replaced), interleaved A B B A."""
    import contextlib
    import statistics
    import time
    from unittest import mock

    import torch

    from aria_slam_tpu_torch.eval import multi_eval
    from aria_slam_tpu_torch.ops import epipolar, linalg

    def gemm_dot(a, b):
        return torch.einsum("...k,...k->...", a, b)

    def gemm_matvec(M, v):
        return torch.einsum("...ik,...k->...i", M, v)

    def gemm_apply(E, x):
        return (E @ x[..., None])[..., 0]

    def gemm():
        stack = contextlib.ExitStack()
        stack.enter_context(mock.patch.object(linalg, "dot", gemm_dot))
        stack.enter_context(mock.patch.object(linalg, "matvec", gemm_matvec))
        stack.enter_context(mock.patch.object(epipolar, "_apply", gemm_apply))
        return stack

    def once(ctx) -> float:
        with ctx():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = frontend(fr, multi_eval.SequenceSampler(gens()), gR, gok)
            [x.cpu() for x in out]
            return (time.perf_counter() - t0) * 1e3

    forms = {"product-sum": contextlib.nullcontext, "batched GEMM": gemm}
    for ctx in forms.values():
        once(ctx)
    ms = {k: [] for k in forms}
    for i in range(reps):
        for k in (list(forms) if i % 2 == 0 else list(forms)[::-1]):
            ms[k].append(once(forms[k]))
    print(f"frontend S={fr.shape[0]} ({fr.shape[0] * (fr.shape[1] - 1)} pairs), median of {reps}: "
          + "; ".join(f"{k} {statistics.median(v):.1f} ms ({', '.join(f'{x:.1f}' for x in v)})"
                      for k, v in ms.items()), flush=True)


if __name__ == "__main__":
    sys.exit(main())
