"""Oracle probe: the scene-depth pin estimators against the ground-truth
|t| (counterpart of the JAX package's eval/pin_probe.py).

For each pair (i, i + lag) of a synthetic rotloop scene, the ratio
pin / |t_gt| of each pin estimator (1.0: the pin recovers the true
translation magnitude given a correct scene-depth prior):

  pin_base         triangulated, estimated pose and inliers (production:
                   ops/epipolar.pair_depths + pin_scale)
  pin_gt           triangulated, ground-truth pose, estimated inliers
  pin_gt_gtinl     triangulated, ground-truth pose and ground-truth
                   epipolar inliers (against pin_gt: inlier selection)
  pin_tfree        t-direction-free debiased parallax ranges
                   (ops/epipolar.tfree_parallax_depths), estimated direction
  pin_tfree_gtdir  the same with the ground-truth direction
  pin_rms          moment-debiased RMS parallax, estimated direction
  pin_rms_gtdir    the same with the ground-truth direction

Every pair's RANSAC runs with its gyro rotation set to the ground truth,
as in the reference probe. Frames are extracted 16 a call and all pairs
go through one match launch and one RANSAC call.

Usage: python -m aria_slam_tpu_torch.eval.pin_probe [--full-res]
    [--frames 240] [--lags 1 2 4] [--device cpu] [--out F]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile

import numpy as np

EXTRACT_BATCH = 16  # frames an ORB call, as the reference probe
ESTIMATORS = ("pin_base", "pin_gt", "pin_gt_gtinl", "pin_tfree", "pin_tfree_gtdir", "pin_rms",
              "pin_rms_gtdir")


def _gt_relative(data, frames: int, lag: int):
    """Ground-truth pair motions x_cur = R x_prev + t (synthetic body ==
    camera): (R (P, 3, 3), t (P, 3)) float32 for the P = frames - lag
    pairs (i, i + lag)."""
    from aria_slam_tpu_torch.eval.metrics import quat_to_mat_np
    from aria_slam_tpu_torch.io import euroc

    def gt_T(i):
        t = float(np.clip(data.image_ts[i], data.gt_ts[0], data.gt_ts[-1]))
        pos, q = euroc.interpolate_gt(data, t)
        T = np.eye(4)
        T[:3, :3] = quat_to_mat_np(np.asarray(q))
        T[:3, 3] = pos
        return T

    Ts = [gt_T(i) for i in range(frames)]
    D = [np.linalg.inv(Ts[i + lag]) @ Ts[i] for i in range(frames - lag)]
    return (np.stack([d[:3, :3] for d in D]).astype(np.float32),
            np.stack([d[:3, 3] for d in D]).astype(np.float32))


def _rms_pin(delta, t_dir, mask, p1, p2, K, sigma_px: float, scene_depth: float):
    """The moment-debiased RMS parallax pin of each pair: the ratio of the
    masked means of sin^2(alpha) z^2 and of the debiased squared ray
    displacement, unbiased in both moments (unlike the per-point 1/beta
    of the t-free estimator)."""
    import torch

    f1 = torch.cat([p1, torch.ones_like(p1[..., :1])], -1)
    f2 = torch.cat([p2, torch.ones_like(p2[..., :1])], -1)
    d1 = f1 / torch.clamp(torch.linalg.norm(f1, dim=-1, keepdim=True), min=1e-9)
    d2p = f2 @ delta.R
    d2p = d2p / torch.clamp(torch.linalg.norm(d2p, dim=-1, keepdim=True), min=1e-9)
    u = d2p - torch.sum(d2p * d1, -1, keepdim=True) * d1
    usq = torch.sum(u * u, -1)
    focal = 0.5 * (K[0, 0] + K[1, 1])
    beta2 = usq - 2.0 * (sigma_px / focal) ** 2  # unbiased, may be negative
    b = -(t_dir[..., None, :] @ delta.R)  # (P, 1, 3)
    b = b / torch.clamp(torch.linalg.norm(b, dim=-1, keepdim=True), min=1e-12)
    bp = b - torch.sum(b * d1, -1, keepdim=True) * d1
    s2z2 = torch.sum(bp * bp, -1) * d1[..., 2] ** 2
    cnt = torch.clamp(mask.float().sum(-1), min=1.0)
    num = torch.where(mask, s2z2, 0.0).sum(-1) / cnt
    den = torch.where(mask, beta2, 0.0).sum(-1) / cnt
    z_rms = torch.sqrt(num / torch.clamp(den, min=1e-12))
    return scene_depth / torch.clamp(z_rms, min=1e-3)


def run(full_res: bool, frames: int = 240, scene_dir: str | None = None,
        verbose: bool = True, lag: int = 1, device=None, sampler=None) -> dict:
    """The probe on the rotloop scene of the accuracy benchmark's
    configuration (written to scene_dir, by default a directory under the
    system's temporary directory, when it holds no scene). lag: pairs
    (i, i + lag). Runs on `device` (CUDA unless asked otherwise); sampler:
    the RANSAC draws for all pairs in one call (ops/epipolar.py; a
    torch.Generator seeded 0 when None). -> {full_res, frames, lag,
    pairs_ok, pairs, sigma_px, estimators: {name: {geomean_ratio,
    log_std, median_ratio}}}."""
    import torch

    from aria_slam_tpu_torch.core import lie
    from aria_slam_tpu_torch.eval.accuracy_benchmark import benchmark_config
    from aria_slam_tpu_torch.io import euroc, synthetic_scene
    from aria_slam_tpu_torch.ops import epipolar as E
    from aria_slam_tpu_torch.ops import match as match_ops, orb
    from aria_slam_tpu_torch.pipeline.slam_pipeline import fetch_many, resolve_device

    dev = resolve_device(device)
    cfg = benchmark_config(full_res=full_res, frames=frames)
    scene_depth = 4.0
    if scene_dir is None:
        scene_dir = os.path.join(tempfile.gettempdir(), f"pin_probe_scene_{frames}_"
                                 + ("full" if full_res else "low"))
    if not os.path.exists(os.path.join(scene_dir, "mav0")):
        synthetic_scene.generate(scene_dir, num_frames=frames, fps=10.0, cam=cfg.camera,
                                 depth=scene_depth, traj="rotloop", period=20.0)
    data = euroc.load(scene_dir)
    cam = cfg.camera
    K = torch.tensor([[cam.fx, 0, cam.cx], [0, cam.fy, cam.cy], [0, 0, 1]], dtype=torch.float32,
                     device=dev)
    focal = 0.5 * (cam.fx + cam.fy)
    in_thresh_sq = (cfg.ransac.inlier_threshold_px / focal) ** 2

    R_gt_np, t_gt_np = _gt_relative(data, frames, lag)
    t_gt_norm = np.linalg.norm(t_gt_np, axis=1)
    t_unit_np = t_gt_np / np.maximum(t_gt_norm[:, None], 1e-12)
    n_pairs = frames - lag

    parts = []
    for s in range(0, frames, EXTRACT_BATCH):
        imgs = np.stack([euroc.load_image(p) for p in data.image_paths[s:s + EXTRACT_BATCH]])
        if imgs.shape[0] < EXTRACT_BATCH:
            imgs = np.concatenate([imgs, np.zeros((EXTRACT_BATCH - imgs.shape[0],)
                                                  + imgs.shape[1:], np.uint8)])
        parts.append(orb.extract_batch(torch.from_numpy(imgs).to(dev).float(), cfg.orb))
        if verbose:
            print(f"extracted {min(s + EXTRACT_BATCH, frames)}/{frames}", flush=True)
    feats = type(parts[0])(**{f.name: torch.cat([getattr(p, f.name) for p in parts])[:frames]
                              for f in dataclasses.fields(parts[0])})
    pf = feats.map(lambda x: x[:n_pairs])
    cf = feats.map(lambda x: x[lag:lag + n_pairs])

    Rg = torch.from_numpy(R_gt_np).to(dev)
    tg = torch.from_numpy(t_unit_np.astype(np.float32)).to(dev)
    if sampler is None:
        sampler = E.TorchSampler(torch.Generator(device=dev).manual_seed(0))
    m = match_ops.match_batched(cf, pf, cfg.matcher.ratio)
    tidx = m.train_idx.long()
    xy_prev = torch.take_along_dim(pf.xy, tidx[..., None], 1)
    valid = m.valid & torch.take_along_dim(pf.valid, tidx, 1) & cf.valid
    delta = E.estimate_pose_gyro_fused(
        xy_prev, cf.xy, valid, K, cfg.ransac, sampler, Rg,
        torch.ones(n_pairs, dtype=torch.bool, device=dev), in_thresh_sq)

    pins = {}
    z1, _, zgood = E.pair_depths(delta, xy_prev, cf.xy, valid, K)
    pins["pin_base"] = E.pin_scale(z1, zgood, scene_depth)[0]
    p1, p2 = E.normalize_points(xy_prev, K), E.normalize_points(cf.xy, K)
    z1g, _ = E.triangulate_depths(Rg, tg, p1, p2)
    z_ok = (z1g > 1e-3) & (z1g < 1e4)
    pins["pin_gt"] = E.pin_scale(z1g, valid & delta.inlier_mask & z_ok, scene_depth)[0]
    sig = cfg.vo_pin_sigma_px
    zt, tgood = E.tfree_parallax_depths(delta, xy_prev, cf.xy, valid, K, sig)
    pins["pin_tfree"] = E.pin_scale(zt, tgood, scene_depth)[0]
    ztg, tggood = E.tfree_parallax_depths(delta.replace(t=tg), xy_prev, cf.xy, valid, K, sig)
    pins["pin_tfree_gtdir"] = E.pin_scale(ztg, tggood, scene_depth)[0]
    # selection-bias oracle: the ground-truth pose and its own epipolar
    # inliers (against pin_gt only WHICH matches count differs)
    inl_gt = (E.sampson_error(lie.skew(tg) @ Rg, p1, p2) < in_thresh_sq) & valid
    pins["pin_gt_gtinl"] = E.pin_scale(z1g, inl_gt & z_ok, scene_depth)[0]
    rms_mask = delta.inlier_mask & valid
    pins["pin_rms"] = _rms_pin(delta, delta.t, rms_mask, p1, p2, K, sig, scene_depth)
    pins["pin_rms_gtdir"] = _rms_pin(delta, tg, rms_mask, p1, p2, K, sig, scene_depth)

    names = list(pins)
    host = fetch_many([pins[n] for n in names] + [delta.success])
    ok = host[-1] & (t_gt_norm > 1e-4)
    out = {"full_res": full_res, "frames": frames, "lag": lag, "pairs_ok": int(ok.sum()),
           "pairs": n_pairs, "sigma_px": cfg.vo_pin_sigma_px, "estimators": {}}
    for name in ESTIMATORS:
        ratio = host[names.index(name)][ok] / t_gt_norm[ok]
        lr = np.log(np.clip(ratio, 1e-6, 1e6))
        out["estimators"][name] = {
            "geomean_ratio": round(float(np.exp(lr.mean())), 3),
            "log_std": round(float(lr.std()), 3),
            "median_ratio": round(float(np.exp(np.median(lr))), 3),
        }
        if verbose:
            print(f"{name:16s} {out['estimators'][name]}", flush=True)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--full-res", action="store_true")
    ap.add_argument("--frames", type=int, default=240)
    ap.add_argument("--scene", default=None)
    ap.add_argument("--out", default=None)
    ap.add_argument("--lags", type=int, nargs="+", default=[1],
                    help="pair lags to sweep (e.g. --lags 1 2 4 8)")
    ap.add_argument("--device", default=None, help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    if args.lags == [1]:
        rep = run(args.full_res, args.frames, args.scene, device=args.device)
    else:
        rep = {f"lag{g}": run(args.full_res, args.frames, args.scene, lag=g, device=args.device)
               for g in args.lags}
    print(json.dumps(rep, indent=1))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


if __name__ == "__main__":
    main()
