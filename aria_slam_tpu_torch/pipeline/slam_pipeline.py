"""SlamPipeline: the online per-frame orchestrator, VO-only (counterpart
of the JAX package's pipeline/slam_pipeline.py).

Per frame: ORB extraction, undistortion, matching against the previous
frame, gyro-fused essential RANSAC, the monocular scale pin or
propagation, pose accumulation, and a pose-graph node + odometry edge;
`finalize` runs the final pose-graph optimisation. The step runs eagerly
on one device; everything between the uploaded image and the pose stays
there. The online EKF fusion, loop closure and mapping, detection,
dynamic filtering and the pipelined (lazy) mode are not ported yet:
asking for them raises NotImplementedError naming the ROADMAP item that
will port them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from aria_slam_tpu_torch.backend import pose_graph
from aria_slam_tpu_torch.config import PipelineConfig
from aria_slam_tpu_torch.core import lie
from aria_slam_tpu_torch.core.types import Features, PoseGraph, make_empty_features
from aria_slam_tpu_torch.ops import epipolar, match as match_ops, orb
from aria_slam_tpu_torch.ops.undistort import undistort_points

# flag -> the ROADMAP.md queue-1 item that ports it
_UNPORTED = {
    "enable_fusion": ("queue 1 item 10 (the online EKF: ekf.frame_step, predict, update "
                      "and pose_covariance)"),
    "enable_loop_closure": ("queue 1 item 10 (the online loop closure: loop_closure.detect, "
                            "keyframe_db.add_keyframe and the online branch)"),
    "enable_mapping": "queue 1 item 10 (the online mapping: mapper.add_from_matches in the step)",
    "enable_detection": "queue 1 item 8 (detector)",
    "enable_dynamic_filtering": "queue 1 item 8 (detector)",
}


def check_supported(cfg: PipelineConfig) -> None:
    """Raise NotImplementedError for a feature the port does not run."""
    for flag, item in _UNPORTED.items():
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{flag}=True is not ported to aria_slam_tpu_torch yet; "
                f"see ROADMAP.md {item}. Set it to False for the VO-only pipeline.")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another; a missing card raises, it never falls back."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return device


@dataclasses.dataclass
class FrameState:
    """The carry of the per-frame step (the VO subset of the reference's)."""

    frame_id: int                   # frames processed so far
    prev_feats: Features
    prev_valid: torch.Tensor        # () bool: have a previous frame
    pose: torch.Tensor              # (4, 4) world-from-camera
    prev_ts: torch.Tensor           # () float32
    # scale propagation: the previous frame's per-slot unit-|t| depths
    # and the running metric scale
    prev_depths: torch.Tensor       # (F,) float32
    prev_depth_mask: torch.Tensor   # (F,) bool
    vo_scale: torch.Tensor          # () float32
    graph: PoseGraph

    def replace(self, **changes) -> "FrameState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class StepOutput:
    pose: torch.Tensor          # (4, 4) world-from-camera after this frame
    num_features: torch.Tensor  # () int32
    num_matches: torch.Tensor   # () int32
    num_inliers: torch.Tensor   # () int32
    vo_success: torch.Tensor    # () bool


def init_state(cfg: PipelineConfig, device) -> FrameState:
    g = pose_graph.init_graph(cfg.pose_graph, device)
    g = pose_graph.set_node(g, 0, torch.eye(4, device=device))
    nf = cfg.orb.num_features
    return FrameState(
        frame_id=0,
        prev_feats=make_empty_features(nf, cfg.orb.descriptor_bits, device),
        prev_valid=torch.tensor(False, device=device),
        pose=torch.eye(4, device=device),
        prev_ts=torch.tensor(0.0, device=device),
        prev_depths=torch.zeros((nf,), device=device),
        prev_depth_mask=torch.zeros((nf,), dtype=torch.bool, device=device),
        vo_scale=torch.tensor(1.0, device=device),
        graph=g,
    )


def gyro_rotation(prev_ts, imu_t, imu_gyr, imu_valid, R_ci):
    """Integrated gyro rotation over the frame's IMU window, in the VO
    delta convention (X_cur = R X_prev + t): compose exp(w dt) in order,
    map body rates to the camera frame, transpose."""
    prev_t = torch.cat([prev_ts[None], imu_t[:-1]])
    dts = torch.clamp(imu_t - prev_t, 0.0, 0.05)
    phis = imu_gyr * dts[:, None] * imu_valid[:, None].to(imu_gyr.dtype)
    steps = lie.so3_exp(phis)
    dR = torch.eye(3, dtype=imu_gyr.dtype, device=imu_gyr.device)
    for k in range(steps.shape[0]):
        dR = dR @ steps[k]
    return (R_ci @ dR @ R_ci.T).T


def make_frame_step(cfg: PipelineConfig, sampler, extractor: Optional[Callable] = None,
                    matcher: Optional[Callable] = None, device="cuda"):
    """Build the per-frame step with injected components."""
    K = torch.as_tensor(cfg.camera.K, device=device)
    R_ci = torch.tensor(cfg.imu_cam_rotation, dtype=torch.float32, device=device)
    extractor = extractor or (lambda img: orb.extract(img, cfg.orb))
    matcher = matcher or (
        lambda q, t: match_ops.match(q, t, cfg.matcher.ratio, cfg.matcher.cross_check))

    def step(state: FrameState, image, imu_t, imu_acc, imu_gyr, imu_valid, ts):
        image = image.to(torch.float32)  # uint8 uploads are exact
        feats = extractor(image)
        feats = feats.replace(xy=undistort_points(feats.xy, cfg.camera))

        # matching (query = current, train = previous)
        m = matcher(feats, state.prev_feats)
        m_valid = m.valid & state.prev_valid
        num_matches = m_valid.to(torch.int32).sum()

        # epipolar VO with the gyro rotation fused where IMU is present
        xy_cur = feats.xy[m.query_idx.long()]
        xy_prev = state.prev_feats.xy[m.train_idx.long()]
        if cfg.gyro_chain_rotation:
            Rg = gyro_rotation(state.prev_ts, imu_t, imu_gyr, imu_valid, R_ci)
            has_g = (imu_valid.to(torch.int32).sum() >= 2) & state.prev_valid
            focal = 0.5 * (K[0, 0] + K[1, 1])
            thresh_sq = (cfg.ransac.inlier_threshold_px / focal) ** 2
            delta = epipolar.estimate_pose_gyro_fused(
                xy_prev, xy_cur, m_valid, K, cfg.ransac, sampler, Rg, has_g, thresh_sq)
        else:
            delta = epipolar.estimate_relative_pose(
                xy_prev, xy_cur, m_valid, K, cfg.ransac, sampler)
            has_g = torch.tensor(False, device=image.device)
        vo_ok = delta.success & state.prev_valid

        # metric scale: "propagate" chains it through features shared with
        # the previous pair, "median_depth" pins every frame to the scene
        # depth, "unit" keeps |t| = 1
        nf = feats.valid.shape[0]
        qidx = m.query_idx.long()
        if cfg.vo_scale_mode in ("median_depth", "propagate"):
            z1, z2, zgood = epipolar.pair_depths(delta, xy_prev, xy_cur, m_valid, K)
            pz, pgood = epipolar.pin_depths(delta, xy_prev, xy_cur, m_valid, K,
                                            cfg.vo_pin_estimator, cfg.vo_pin_sigma_px)
            pin, _ = epipolar.pin_scale(pz, pgood, cfg.vo_scene_depth)
            if cfg.vo_scale_mode == "propagate":
                tidx = m.train_idx.long()
                shared = zgood & state.prev_depth_mask[tidx]
                ratio, cnt = epipolar.geomean_ratio(state.prev_depths[tidx], z1, shared)
                scale = torch.where(cnt >= 10, state.vo_scale * ratio, pin)
            else:
                scale = pin
            scale = torch.clamp(scale, 0.01, 100.0)
            t_use = delta.t * scale
            new_depths = torch.zeros((nf,), device=image.device).index_put(
                (qidx,), torch.where(zgood, z2, 0.0))
            new_dmask = torch.zeros((nf,), dtype=torch.bool, device=image.device).index_put(
                (qidx,), zgood) & vo_ok
            new_scale = torch.where(vo_ok, scale, state.vo_scale)
        else:
            t_use = delta.t
            new_depths = torch.zeros((nf,), device=image.device)
            new_dmask = torch.zeros((nf,), dtype=torch.bool, device=image.device)
            new_scale = state.vo_scale
        T_cur_prev = lie.se3_matrix(delta.R, t_use)
        pose_new = torch.where(vo_ok, state.pose @ lie.se3_inverse(T_cur_prev), state.pose)

        # pose graph: a node every frame, its odometry edge only when VO
        # succeeded
        node_id = state.frame_id + 1
        graph = pose_graph.set_node(state.graph, node_id, pose_new)
        rel = lie.se3_inverse(state.pose) @ pose_new
        graph_with_edge = pose_graph.add_odometry_edge(
            graph, node_id - 1, node_id, rel, cfg.pose_graph,
            r_weight=torch.where(has_g, cfg.pose_graph.gyro_rot_weight, 1.0))
        graph = pose_graph.select(vo_ok, graph_with_edge, graph)

        new_state = FrameState(
            frame_id=node_id, prev_feats=feats,
            prev_valid=torch.tensor(True, device=image.device), pose=pose_new,
            prev_ts=ts, prev_depths=new_depths, prev_depth_mask=new_dmask,
            vo_scale=new_scale, graph=graph,
        )
        out = StepOutput(pose=pose_new, num_features=feats.num_valid(),
                         num_matches=num_matches, num_inliers=delta.num_inliers,
                         vo_success=vo_ok)
        return new_state, out

    return step


class SlamPipeline:
    """Host-side orchestrator around the per-frame step.

    Parity API: processFrame / processIMU / finalize / trajectory. Runs
    on CUDA unless `device` says otherwise; RANSAC draws from an explicit
    torch.Generator seeded with `seed`, or from `sampler` when given
    (see ops/epipolar.py).
    """

    def __init__(self, config: PipelineConfig | None = None, *, device=None,
                 extractor=None, matcher=None, sampler=None, seed: int = 0,
                 lazy_depth: int = 0):
        self.config = config or PipelineConfig()
        check_supported(self.config)
        if lazy_depth:
            raise NotImplementedError(
                "the pipelined (lazy_depth > 0) online mode is not ported to "
                "aria_slam_tpu_torch yet; see ROADMAP.md queue 1 item 10")
        self.device = resolve_device(device)
        if sampler is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            sampler = epipolar.TorchSampler(gen)
        self._step = make_frame_step(self.config, sampler, extractor, matcher, self.device)
        self.state = init_state(self.config, self.device)
        self._imu_buf: list = []
        self._t0: float | None = None
        self.on_pose: Optional[Callable] = None
        self.trajectory: list = []  # (ts, 4x4 pose) after each frame
        self.last_output: StepOutput | None = None
        self.num_loops = 0  # the online loop closure is not ported (check_supported)

    # parity: processIMU(ImuMeasurement)
    def process_imu(self, timestamp: float, accel, gyro) -> None:
        self._imu_buf.append((timestamp, np.asarray(accel, np.float32),
                              np.asarray(gyro, np.float32)))

    def _drain_imu(self, ts: float):
        w = self.config.ekf.imu_window
        t = np.zeros(w, np.float32)
        a = np.zeros((w, 3), np.float32)
        g = np.zeros((w, 3), np.float32)
        v = np.zeros(w, bool)
        take = [s for s in self._imu_buf if s[0] <= ts]
        self._imu_buf = [s for s in self._imu_buf if s[0] > ts]
        for i, (tt, aa, gg) in enumerate(take[-w:]):  # newest w samples
            t[i] = self._rel(tt)
            a[i] = aa
            g[i] = gg
            v[i] = True
        return t, a, g, v

    def _rel(self, ts: float) -> float:
        """Sequence-relative seconds keep float32 timestamps accurate."""
        if self._t0 is None:
            self._t0 = ts
        return float(ts - self._t0)

    # parity: processFrame(data, w, h, ts) -> Pose
    def process_frame(self, image: np.ndarray, timestamp: float) -> np.ndarray:
        ts = self._rel(timestamp)
        imu = self._drain_imu(timestamp)
        dev = self.device
        img = torch.from_numpy(np.ascontiguousarray(image)).to(dev)
        self.state, out = self._step(
            self.state, img, *(torch.from_numpy(x).to(dev) for x in imu),
            torch.tensor(ts, dtype=torch.float32, device=dev))
        self.last_output = out
        pose = self.state.pose.cpu().numpy()
        self.trajectory.append((timestamp, pose))
        if self.on_pose is not None:
            self.on_pose(timestamp, pose)
        return pose

    def export_map(self, ply_path: Optional[str] = None,
                   pcd_path: Optional[str] = None) -> int:
        """The online step builds no map yet (enable_mapping raises): the
        files are written with no point."""
        from aria_slam_tpu_torch.mapping import export, mapper

        empty = mapper.init_map(dataclasses.replace(self.config.mapper, max_points=0), "cpu")
        return export.export_map(empty, ply_path, pcd_path)

    # final global optimisation (parity: optimize(50) at the end)
    def finalize(self) -> None:
        g = pose_graph.optimize(self.state.graph, self.config.pose_graph,
                                self.config.pose_graph.final_lm_iterations)
        self.state = self.state.replace(graph=g)
        n = len(self.trajectory)
        poses = g.node_pose[1: n + 1].cpu().numpy()
        self.trajectory = [(ts, poses[i]) for i, (ts, _) in enumerate(self.trajectory)]
