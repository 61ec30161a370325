"""SlamPipeline: the online per-frame orchestrator (counterpart of the JAX
package's pipeline/slam_pipeline.py).

Per frame: ORB extraction, undistortion, matching against the previous
frame, gyro-fused essential RANSAC, the monocular scale pin or
propagation, pose accumulation, a pose-graph node + odometry edge, the
map insert (the inlier matches triangulated against the previous frame)
and loop detection against the keyframe DB before the frame's own
insert. A detected loop adds a loop edge, optimises the graph and
rebases the running pose on it (`_handle_loop`); the EKF fuses the
frame's IMU window with its VO pose. `finalize` runs the final
optimisation.

The step runs eagerly on one device and writes the keyframe DB and the
map in place. Reads on the host, a frame: one inside the step when loop
closure is on (whether any candidate is worth verifying,
loop_closure.detect), and one when the frame is published (its pose, VO
flag and loop flag, in one copy); a loop adds the reads of its edge and
of the rebased pose. The EKF consumes only the published pose and VO
flag, and nothing in the step consumes the EKF, so it runs at
publishing, on the host (EKF_ON_HOST). With lazy_depth > 0 (pipelined mode)
process_frame returns None and publishes each frame lazy_depth frames
late, so the host enqueues the next steps while the card runs.
Detection and dynamic filtering are not ported yet: asking for them
raises NotImplementedError naming the ROADMAP item that will port them.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from aria_slam_tpu_torch.backend import keyframe_db, loop_closure, pose_graph
from aria_slam_tpu_torch.backend.loop_closure import LoopResult
from aria_slam_tpu_torch.config import PipelineConfig
from aria_slam_tpu_torch.core import lie
from aria_slam_tpu_torch.core.types import (
    EkfState, Features, KeyframeDB, MapState, PoseGraph, make_empty_features,
)
from aria_slam_tpu_torch.fusion import ekf
from aria_slam_tpu_torch.mapping import export, mapper
from aria_slam_tpu_torch.ops import epipolar, match as match_ops, orb
from aria_slam_tpu_torch.ops.undistort import undistort_points

# The online EKF runs on the host whatever device the step runs on: a
# frame's 10-20 predicts and one update are a few dozen 15 x 15 ops each,
# which cost less on the CPU than as launches on the card (PERF.md: the
# online phase of chip_smoke.py times both routes on the run's own
# inputs). It runs from the pose that publishing reads anyway.
EKF_ON_HOST = True

# flag -> the ROADMAP.md queue-1 item that ports it
_UNPORTED = {
    "enable_detection": "queue 1 item 8 (detector)",
    "enable_dynamic_filtering": "queue 1 item 8 (detector)",
}


def check_supported(cfg: PipelineConfig) -> None:
    """Raise NotImplementedError for a feature the port does not run."""
    for flag, item in _UNPORTED.items():
        if getattr(cfg, flag):
            raise NotImplementedError(
                f"{flag}=True is not ported to aria_slam_tpu_torch yet; "
                f"see ROADMAP.md {item}. Set it to False.")


def resolve_device(device) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller asks
    for another; a missing card raises, it never falls back."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "the plain PyTorch path on the CPU")
    return device


def ekf_device(device) -> torch.device:
    """Where the online EKF of a step on `device` runs (EKF_ON_HOST)."""
    return torch.device("cpu") if EKF_ON_HOST else torch.device(device)


_NP_DTYPES = {torch.bool: np.bool_, torch.uint8: np.uint8, torch.int8: np.int8,
              torch.int32: np.int32, torch.int64: np.int64, torch.float32: np.float32}


def fetch_many(tensors) -> list:
    """Several device tensors as numpy arrays through ONE copy to the
    host: their bytes are concatenated on the device, copied once and
    viewed back, so every dtype arrives exactly (bool, int32, float32)."""
    flat = [t.contiguous().reshape(-1).view(torch.uint8) for t in tensors]
    host = torch.cat(flat).cpu().numpy()
    outs, off = [], 0
    for t, f in zip(tensors, flat):
        n = f.numel()
        outs.append(host[off:off + n].view(_NP_DTYPES[t.dtype]).reshape(tuple(t.shape)).copy())
        off += n
    return outs


@dataclasses.dataclass
class FrameState:
    """The carry of the per-frame step."""

    frame_id: int                   # frames processed so far (the last frame's node id)
    prev_feats: Features
    prev_valid: torch.Tensor        # () bool: have a previous frame
    pose: torch.Tensor              # (4, 4) world-from-camera
    prev_ts: torch.Tensor           # () float32
    # scale propagation: the previous frame's per-slot unit-|t| depths
    # and the running metric scale
    prev_depths: torch.Tensor       # (F,) float32
    prev_depth_mask: torch.Tensor   # (F,) bool
    vo_scale: torch.Tensor          # () float32
    ekf_state: EkfState             # on ekf_device(the step's device)
    db: KeyframeDB
    map_state: MapState
    graph: PoseGraph

    def replace(self, **changes) -> "FrameState":
        return dataclasses.replace(self, **changes)


@dataclasses.dataclass
class StepOutput:
    pose: torch.Tensor          # (4, 4) world-from-camera after this frame
    num_features: torch.Tensor  # () int32
    num_matches: torch.Tensor   # () int32
    num_inliers: torch.Tensor   # () int32
    num_filtered: torch.Tensor  # () int32: matches the dynamic filter dropped (0: not ported)
    vo_success: torch.Tensor    # () bool
    loop: LoopResult
    # the EKF position and quaternion after this frame, set when it is
    # published (process_frame in sync mode, the pop in lazy mode)
    fused_pos: Optional[torch.Tensor] = None   # (3,)
    fused_quat: Optional[torch.Tensor] = None  # (4,)


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
        ekf_state=ekf.init_state(device=ekf_device(device)),
        db=keyframe_db.init_db(cfg.loop, cfg.orb, device),
        map_state=mapper.init_map(cfg.mapper, device),
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
    """Build the per-frame step with injected components. The loop
    verification draws from `sampler` with the stages "loop_essential" /
    "loop_homography"."""
    K = torch.as_tensor(cfg.camera.K, device=device)
    R_ci = torch.tensor(cfg.imu_cam_rotation, dtype=torch.float32, device=device)
    extractor = extractor or (lambda img: orb.extract(img, cfg.orb))
    matcher = matcher or (
        lambda q, t: match_ops.match(q, t, cfg.matcher.ratio, cfg.matcher.cross_check))

    def loop_sampler(valid, num_hypotheses, sample_size, stage):
        return sampler(valid, num_hypotheses, sample_size, "loop_" + stage)

    def step(state: FrameState, image, imu_t, imu_acc, imu_gyr, imu_valid, ts):
        image = image.to(torch.float32)  # uint8 uploads are exact
        dev = image.device
        feats = extractor(image)
        feats = feats.replace(xy=undistort_points(feats.xy, cfg.camera))

        # matching (query = current, train = previous)
        m = matcher(feats, state.prev_feats)
        m_valid = m.valid & state.prev_valid
        num_matches = m_valid.to(torch.int32).sum()

        # epipolar VO with the gyro rotation fused where IMU is present
        xy_cur, xy_prev, _ = epipolar.gather_correspondences(feats.xy, state.prev_feats.xy, m)
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
            has_g = torch.tensor(False, device=dev)
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
            new_depths = torch.zeros((nf,), device=dev).index_put(
                (qidx,), torch.where(zgood, z2, 0.0))
            new_dmask = torch.zeros((nf,), dtype=torch.bool, device=dev).index_put(
                (qidx,), zgood) & vo_ok
            new_scale = torch.where(vo_ok, scale, state.vo_scale)
        else:
            t_use = delta.t
            new_depths = torch.zeros((nf,), device=dev)
            new_dmask = torch.zeros((nf,), dtype=torch.bool, device=dev)
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

        # mapping: the inlier matches triangulated against the previous
        # frame (camera-from-world ends), coloured from this image
        map_state = state.map_state
        if cfg.enable_mapping:
            map_state = mapper.add_from_matches(
                map_state, K, lie.se3_inverse(state.pose), lie.se3_inverse(pose_new),
                xy_prev, xy_cur, m_valid & delta.inlier_mask & vo_ok, image, cfg.mapper)

        # loop closure: query BEFORE inserting the current frame
        db = state.db
        if cfg.enable_loop_closure:
            loop = loop_closure.detect(
                db, feats, state.frame_id, K, cfg.loop, cfg.ransac, loop_sampler,
                cfg.vo_scale_mode, cfg.vo_scene_depth, depths=new_depths,
                depth_mask=new_dmask, depth_scale=new_scale)
            cur_slot = db.head.long().reshape(1)  # where the insert puts this frame
            db = keyframe_db.add_keyframe(db, feats, state.frame_id, pose_new)
            # an accepted loop pair observes the same scene: link it in the
            # covisibility graph, unless the insert just evicted the
            # matched keyframe (at capacity the oldest slot, which passes
            # the gap gate most easily); no loop links nothing
            link = (loop.detected & (loop.slot != cur_slot[0])).reshape(1)
            a = torch.where(link, loop.slot.long(), cur_slot)
            for ij in ((a, cur_slot), (cur_slot, a)):
                db.covis.index_put_(ij, db.covis[ij] | link)
        else:
            loop = loop_closure.no_loop(dev)

        new_state = FrameState(
            frame_id=node_id, prev_feats=feats,
            prev_valid=torch.tensor(True, device=dev), pose=pose_new,
            prev_ts=ts, prev_depths=new_depths, prev_depth_mask=new_dmask,
            vo_scale=new_scale, ekf_state=state.ekf_state, db=db, map_state=map_state,
            graph=graph,
        )
        out = StepOutput(pose=pose_new, num_features=feats.num_valid(),
                         num_matches=num_matches, num_inliers=delta.num_inliers,
                         num_filtered=torch.zeros((), dtype=torch.int32, device=dev),
                         vo_success=vo_ok, loop=loop)
        return new_state, out

    return step


class SlamPipeline:
    """Host-side orchestrator around the per-frame step.

    Parity API: processFrame / processIMU / callbacks (on_pose, on_loop) /
    finalize / trajectory / the map. Runs on CUDA unless `device` says
    otherwise; RANSAC draws from an explicit torch.Generator seeded with
    `seed`, or from `sampler` when given (see ops/epipolar.py).
    lazy_depth > 0: the pipelined mode (see the module docstring); read
    the trajectory after `flush` or `finalize`.
    """

    def __init__(self, config: PipelineConfig | None = None, *, device=None,
                 extractor=None, matcher=None, sampler=None, seed: int = 0,
                 lazy_depth: int = 0):
        self.config = config or PipelineConfig()
        check_supported(self.config)
        self.device = resolve_device(device)
        if sampler is None:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed)
            sampler = epipolar.TorchSampler(gen)
        self._step = make_frame_step(self.config, sampler, extractor, matcher, self.device)
        self.state = init_state(self.config, self.device)
        self._ekf_consts = ekf._Consts(self.config.ekf, torch.float32, ekf_device(self.device))
        self._imu_buf: list = []
        self._t0: float | None = None
        self.on_pose: Optional[Callable] = None
        self.on_loop: Optional[Callable] = None
        self.num_loops = 0
        # accepted loops as (matched frame, query frame) indices, as
        # ChunkedSlam.loop_pairs
        self.loop_pairs: list = []
        self.trajectory: list = []  # (ts, 4x4 pose) after each frame
        self.last_output: StepOutput | None = None
        # pipelined mode: dispatched frames waiting to be published
        self._lazy = int(lazy_depth)
        self._pending: list = []

    # parity: processIMU(ImuMeasurement)
    def process_imu(self, timestamp: float, accel, gyro) -> None:
        self._imu_buf.append((timestamp, np.asarray(accel, np.float32),
                              np.asarray(gyro, np.float32)))

    def _drain_imu(self, ts: float):
        """The samples up to ts, newest `imu_window` of them, packed first
        into the padded window -> (t, accel, gyro, valid) host arrays."""
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
    def process_frame(self, image: np.ndarray, timestamp: float) -> np.ndarray | None:
        ts = self._rel(timestamp)
        imu = self._drain_imu(timestamp)
        dev = self.device
        img = torch.from_numpy(np.ascontiguousarray(image)).to(dev)
        self.state, out = self._step(
            self.state, img, *(torch.from_numpy(x).to(dev) for x in imu),
            torch.tensor(ts, dtype=torch.float32, device=dev))
        self.last_output = out
        # the frame's node id, and the loops applied when it was dispatched
        frame = (timestamp, ts, imu, out, self.state.frame_id, self.num_loops)
        if not self._lazy:
            return self._publish(*frame)
        self._pending.append(frame)
        if len(self._pending) > self._lazy:
            self._publish(*self._pending.pop(0))
        return None

    def _publish(self, timestamp, ts, imu, out: StepOutput, node_id: int,
                 loops_at_dispatch: int) -> np.ndarray:
        """Read a dispatched frame's results (one copy), run its EKF step,
        apply its loop and append its pose to the trajectory."""
        pose, vo_ok, detected = fetch_many([out.pose, out.vo_success, out.loop.detected])
        if self.config.enable_fusion:
            self._fuse(imu, ts, pose, vo_ok)
        out.fused_pos, out.fused_quat = self.state.ekf_state.pos, self.state.ekf_state.quat
        if detected:
            self._handle_loop(out, node_id)
        if self.num_loops > loops_at_dispatch:
            # a loop optimisation landed after this frame was dispatched (its
            # own, or in lazy mode a later pop's): publish the node's
            # optimised pose, as the rebased running pose is in sync mode
            pose = pose_graph.get_pose(self.state.graph, node_id).cpu().numpy()
        self.trajectory.append((timestamp, pose))
        if self.on_pose is not None:
            self.on_pose(timestamp, pose)
        return pose

    def _fuse(self, imu, ts: float, pose: np.ndarray, vo_ok: np.ndarray) -> None:
        """The frame's EKF step: predicts over its IMU window, then the VO
        pose as the measurement (valid where VO succeeded, and always
        until the filter is initialised)."""
        s = self.state.ekf_state
        dev = s.P.device

        def t(x):
            return torch.as_tensor(x, dtype=torch.float32, device=dev)

        imu_t, imu_a, imu_g, imu_v = imu
        new = ekf.frame_step(
            s, t(imu_t), t(imu_a), t(imu_g), imu_v, t(pose[:3, :3]), t(pose[:3, 3]),
            torch.as_tensor(vo_ok, device=dev) | ~s.initialized, t(ts), self.config.ekf,
            self._ekf_consts)
        self.state = self.state.replace(ekf_state=new)

    def flush(self) -> None:
        """Publish every dispatched frame (pipelined mode); call before
        reading the trajectory."""
        while self._pending:
            self._publish(*self._pending.pop(0))

    def _handle_loop(self, out: StepOutput, node_id: int) -> None:
        """Parity: on a loop, addLoopEdge + optimize + adopt the pose. The
        loop's query frame is node node_id; the matched keyframe's frame
        id f is node f + 1 (node 0 is the origin before the first frame)."""
        cfgpg = self.config.pose_graph
        fid, twt, score = fetch_many([out.loop.frame_id, out.loop.t_weight, out.loop.score])
        # T_rel maps current-cam points into matched-cam coordinates,
        # T_{matched<-current}: with world-from-camera nodes the edge (i =
        # matched, j = current) measures T_i^-1 T_j, which is T_rel itself
        g = pose_graph.add_loop_edge(self.state.graph, int(fid) + 1, node_id, out.loop.T_rel,
                                     cfgpg, t_weight=float(twt))
        g = pose_graph.optimize(g, cfgpg)
        # rebase the running pose on the newest dispatched node (in lazy
        # mode frames after the loop's query frame already exist)
        self.state = self.state.replace(graph=g,
                                        pose=pose_graph.get_pose(g, self.state.frame_id))
        self.num_loops += 1
        self.loop_pairs.append((int(fid), node_id - 1))
        if self.on_loop is not None:
            self.on_loop(int(fid), node_id - 1, float(score))

    # final global optimisation (parity: optimize(50) at the end)
    def finalize(self) -> None:
        self.flush()
        g = pose_graph.optimize(self.state.graph, self.config.pose_graph,
                                self.config.pose_graph.final_lm_iterations)
        self.state = self.state.replace(graph=g)
        n = len(self.trajectory)
        poses = g.node_pose[1: n + 1].cpu().numpy()
        self.trajectory = [(ts, poses[i]) for i, (ts, _) in enumerate(self.trajectory)]

    # map access (parity: the IMapper surface)
    def get_map(self) -> MapState:
        return mapper.filter_outliers(self.state.map_state, self.config.mapper.outlier_sigma)

    def export_map(self, ply_path: Optional[str] = None,
                   pcd_path: Optional[str] = None) -> int:
        return export.export_map(self.get_map(), ply_path, pcd_path)

    @property
    def fused_pose(self) -> np.ndarray:
        s = self.state.ekf_state
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = lie.quat_to_mat(s.quat).cpu().numpy()
        T[:3, 3] = s.pos.cpu().numpy()
        return T

    @property
    def fused_pose_covariance(self) -> np.ndarray:
        """6 x 6 [dp, dtheta] covariance of the fused pose (parity:
        core::Pose.covariance, include/core/Types.hpp:66-70)."""
        return ekf.pose_covariance(self.state.ekf_state).cpu().numpy()
