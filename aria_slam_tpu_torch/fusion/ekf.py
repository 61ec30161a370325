"""15-state error-state EKF for visual-inertial fusion: the online
per-frame step, and offline the merged-stream filter with its RTS
smoother (counterpart of the JAX package's fusion/ekf.py).

Parity: the reference SensorFusion (src/legacy/IMU.cpp:104-305): state
[p(3), v(3), dtheta(3), b_a(3), b_g(3)], the same F / G Jacobians, the
Joseph-form update, the noise defaults, the dt gate (0 < dt <= 0.1 s)
and the start from the first visual pose.

`run_sequence` merges the IMU and VO streams into one time-ordered event
list and runs the filter over it event by event, eagerly, on the device
of its inputs: each event is a predict (IMU) or an update (VO), chosen
on the host from the merged tags (one copy), with the gates as tensor
selects so no event reads the device. The smoother's gains depend only
on the forward covariances, so they are solved for every event in one
batched Cholesky solve, leaving a backward scan of 15 x 15 mat-vecs.

Online, `frame_step` runs the predict of every valid IMU sample of the
frame's window, then the visual update (`predict`, `update`); the
reference scans the whole padded window and keeps the state at the
invalid samples, which is the same result. `pose_covariance` is the
fused pose's 6 x 6 marginal.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from aria_slam_tpu_torch.config import EkfConfig
from aria_slam_tpu_torch.core import lie
from aria_slam_tpu_torch.core.types import EkfState
from aria_slam_tpu_torch.ops.linalg import cholesky_solve, inv_psd


def init_state(dtype=torch.float32, device="cuda") -> EkfState:
    """Parity: the SensorFusion constructor's P (IMU.cpp:108-115)."""
    p_diag = torch.tensor([0.01] * 3 + [0.01] * 3 + [0.01] * 3 + [0.001] * 3 + [0.0001] * 3,
                          dtype=dtype, device=device)
    zeros = torch.zeros(3, dtype=dtype, device=device)
    return EkfState(pos=zeros, vel=zeros, quat=lie.quat_identity(dtype=dtype, device=device),
                    ba=zeros, bg=zeros, P=torch.diag(p_diag),
                    last_imu_t=torch.tensor(-1.0, dtype=dtype, device=device),
                    initialized=torch.tensor(False, device=device))


def pose_covariance(state: EkfState) -> torch.Tensor:
    """6 x 6 covariance of the fused pose over [dp(3), dtheta(3)]: the
    marginal of P over the position and orientation-error blocks
    (parity: core::Pose.covariance, include/core/Types.hpp:66-70)."""
    idx = torch.tensor([0, 1, 2, 6, 7, 8], device=state.P.device)
    return state.P[idx][:, idx]


def process_noise(cfg: EkfConfig, dtype=torch.float32, device="cuda") -> torch.Tensor:
    """12 x 12 Q: [accel noise, gyro noise, accel bias walk, gyro bias walk]
    (IMU.cpp:117-121)."""
    diag = ([cfg.accel_noise ** 2] * 3 + [cfg.gyro_noise ** 2] * 3
            + [cfg.accel_bias_walk ** 2] * 3 + [cfg.gyro_bias_walk ** 2] * 3)
    return torch.diag(torch.tensor(diag, dtype=dtype, device=device))


def measurement_noise(cfg: EkfConfig, dtype=torch.float32, device="cuda") -> torch.Tensor:
    diag = [cfg.pos_noise ** 2] * 3 + [cfg.rot_noise ** 2] * 3
    return torch.diag(torch.tensor(diag, dtype=dtype, device=device))


def _linear_maps():
    """The quadratic and linear quaternion formulas of core/lie.py as
    constant matrices, so that an event step makes a few launches where
    the per-entry formulas make dozens: vec(R(q)) = C + M vec(q q^T),
    vec(L(a)) = A a with quat_mul(a, b) = L(a) b, vec(skew(v)) = S v. R and
    skew come out bit for bit as the formulas give them (two products a
    sum, scaled by 2); quat_mul within an ulp."""
    w, x, y, z = range(4)
    M = np.zeros((9, 16))
    for r, terms in enumerate([
            [(y, y, -2), (z, z, -2)], [(x, y, 2), (w, z, -2)], [(x, z, 2), (w, y, 2)],
            [(x, y, 2), (w, z, 2)], [(x, x, -2), (z, z, -2)], [(y, z, 2), (w, x, -2)],
            [(x, z, 2), (w, y, -2)], [(y, z, 2), (w, x, 2)], [(x, x, -2), (y, y, -2)]]):
        for i, j, c in terms:
            M[r, 4 * i + j] = c
    A = np.zeros((16, 4))
    for r, row in enumerate([[(w, 1), (x, -1), (y, -1), (z, -1)], [(x, 1), (w, 1), (z, -1), (y, 1)],
                             [(y, 1), (z, 1), (w, 1), (x, -1)], [(z, 1), (y, -1), (x, 1), (w, 1)]]):
        for col, (comp, sign) in enumerate(row):
            A[4 * r + col, comp] = sign
    S = np.zeros((9, 3))
    for (r, c), (comp, sign) in {(0, 1): (2, -1), (0, 2): (1, 1), (1, 0): (2, 1),
                                 (1, 2): (0, -1), (2, 0): (1, -1), (2, 1): (0, 1)}.items():
        S[3 * r + c, comp] = sign
    return M, A, S


def _placement(shape, blocks):
    """The 0/1 matrix that writes a stack of 3 x 3 blocks, flattened, into
    a flattened matrix of `shape` at the (row, column) block offsets."""
    P = np.zeros((shape[0] * shape[1], 9 * len(blocks)))
    for b, (r0, c0) in enumerate(blocks):
        for i in range(3):
            for j in range(3):
                P[(r0 + i) * shape[1] + c0 + j, 9 * b + 3 * i + j] = 1.0
    return P


class _Consts:
    """The event steps' constant tensors, made once a sequence."""

    def __init__(self, cfg: EkfConfig, dtype, device):
        def t(x):
            return torch.as_tensor(x, dtype=dtype, device=device)

        self.g = t(cfg.gravity)
        self.eye3 = torch.eye(3, dtype=dtype, device=device)
        self.eye15 = torch.eye(15, dtype=dtype, device=device)
        self.Q = process_noise(cfg, dtype, device)
        self.Rm = measurement_noise(cfg, dtype, device)
        self.H = torch.zeros((6, 15), dtype=dtype, device=device)
        self.H[0:3, 0:3] = self.eye3
        self.H[3:6, 6:9] = self.eye3
        self.zero = t(0.0)
        self.zero3 = torch.zeros(3, dtype=dtype, device=device)
        self.zero15 = torch.zeros(15, dtype=dtype, device=device)
        self.max_dt = cfg.max_dt
        M, A, S = _linear_maps()
        self.rot_map, self.rot_const = t(M), self.eye3.reshape(9)
        self.left_map, self.skew_map = t(A), t(S)
        # where predict's dt-scaled 3 x 3 blocks go in F (15 x 15, on the
        # identity) and in G (15 x 12)
        self.F_place = t(_placement((15, 15), [(0, 3), (0, 6), (0, 9), (3, 6), (3, 9), (6, 12)]))
        self.G_place = t(_placement((15, 12), [(0, 0), (3, 0), (6, 3), (9, 6), (12, 9)]))
        self.eye15_flat = self.eye15.reshape(225)

    def rot(self, q):
        """lie.quat_to_mat for one quaternion."""
        return (self.rot_const + self.rot_map @ (q[:, None] * q[None, :]).reshape(16)).view(3, 3)

    def qmul(self, a, b):
        """lie.quat_mul for one pair."""
        return (self.left_map @ a).view(4, 4) @ b

    def skew(self, v):
        return (self.skew_map @ v).view(3, 3)


def _predict_core(state: EkfState, t, accel, gyro, cfg: EkfConfig, k: _Consts = None):
    """One IMU propagation step (parity: predictEKF, IMU.cpp:139-222) and
    the error-state transition it applied: the dynamics Jacobian when
    the step ran, the identity when gated (dt <= 0, dt > max_dt, the
    first sample, or the filter not initialised), since every
    dt-scaled block of F vanishes with dt = 0. -> (new_state, F)."""
    k = k or _Consts(cfg, state.P.dtype, state.P.device)
    dt = t - state.last_imu_t
    ok = state.initialized & (state.last_imu_t >= 0) & (dt > 0) & (dt <= k.max_dt)
    dt = torch.where(ok, dt, k.zero)
    half_dt2 = 0.5 * dt * dt
    neg_dt = -dt

    a = accel - state.ba
    w = gyro - state.bg
    R = k.rot(state.quat)

    # nominal state propagation (no midpoint, as the reference)
    quat_new = lie.quat_normalize(k.qmul(state.quat, lie.so3_exp_quat(w * dt)))
    a_world = R @ a + k.g
    pos_new = state.pos + state.vel * dt + a_world * half_dt2
    vel_new = state.vel + a_world * dt

    # error-state Jacobians: F = I plus the blocks dp/dv, dp/dtheta,
    # dp/dba, dv/dtheta, dv/dba, dtheta/dbg; G maps the 12 noises
    Ra = R @ k.skew(a)
    I_dt = k.eye3 * dt
    F = (k.eye15_flat + k.F_place @ torch.stack([
        I_dt, Ra * -half_dt2, R * -half_dt2, Ra * neg_dt, R * neg_dt, -I_dt]).reshape(54)
         ).view(15, 15)
    G = (k.G_place @ torch.stack([R * half_dt2, R * dt, I_dt, I_dt, I_dt]).reshape(45)
         ).view(15, 12)

    P_new = F @ state.P @ F.T + G @ k.Q @ G.T
    P_new = 0.5 * (P_new + P_new.T)

    new = EkfState(
        pos=torch.where(ok, pos_new, state.pos),
        vel=torch.where(ok, vel_new, state.vel),
        quat=torch.where(ok, quat_new, state.quat),
        ba=state.ba,
        bg=state.bg,
        P=torch.where(ok, P_new, state.P),
        last_imu_t=torch.where(state.initialized, t, state.last_imu_t),
        initialized=state.initialized,
    )
    return new, F


def _update_core(state: EkfState, R_meas, t_meas, timestamp, cfg: EkfConfig,
                 meas_valid=True, k: _Consts = None):
    """One visual-pose update (parity: addVisualPose / updateEKF,
    IMU.cpp:224-305); the first valid measurement initialises the state.
    -> (new_state, dx_eff, did_init): dx_eff the correction the update
    applied to the error state (zeros when gated or initialising), and
    did_init the initialisation event, a barrier of the smoother."""
    k = k or _Consts(cfg, state.P.dtype, state.P.device)
    meas_valid = torch.as_tensor(meas_valid, device=state.P.device)
    q_meas = lie.mat_to_quat(R_meas)
    do_init = meas_valid & ~state.initialized

    pos_innov = t_meas - state.pos
    q_err = lie.quat_normalize(lie.quat_mul(q_meas, lie.quat_conj(state.quat)))
    innov = torch.cat([pos_innov, lie.so3_log_quat(q_err)])

    H = k.H
    S = H @ state.P @ H.T + k.Rm
    K = state.P @ H.T @ inv_psd(S)
    dx = K @ innov

    pos_u = state.pos + dx[0:3]
    vel_u = state.vel + dx[3:6]
    quat_u = lie.quat_normalize(lie.quat_mul(lie.so3_exp_quat(dx[6:9]), state.quat))
    ba_u = state.ba + dx[9:12]
    bg_u = state.bg + dx[12:15]

    I_KH = k.eye15 - K @ H
    P_u = I_KH @ state.P @ I_KH.T + K @ k.Rm @ K.T
    P_u = 0.5 * (P_u + P_u.T)

    do_update = meas_valid & state.initialized

    def pick(init_val, upd_val, keep_val):
        return torch.where(do_init, init_val, torch.where(do_update, upd_val, keep_val))

    new = EkfState(
        pos=pick(t_meas, pos_u, state.pos),
        vel=pick(k.zero3, vel_u, state.vel),
        quat=pick(q_meas, quat_u, state.quat),
        ba=pick(state.ba, ba_u, state.ba),
        bg=pick(state.bg, bg_u, state.bg),
        P=pick(state.P, P_u, state.P),
        last_imu_t=torch.where(do_init, timestamp, state.last_imu_t),
        initialized=state.initialized | do_init,
    )
    return new, torch.where(do_update, dx, k.zero15), do_init


def predict(state: EkfState, t, accel, gyro, cfg: EkfConfig, k: _Consts = None) -> EkfState:
    """One IMU propagation step (parity: predictEKF, IMU.cpp:139-222); a
    no-op but for the timestamp when gated (see _predict_core)."""
    return _predict_core(state, t, accel, gyro, cfg, k)[0]


def update(state: EkfState, R_meas, t_meas, timestamp, cfg: EkfConfig, meas_valid=True,
           k: _Consts = None) -> EkfState:
    """One visual-pose update (parity: addVisualPose / updateEKF,
    IMU.cpp:224-305); the first valid measurement initialises the state."""
    return _update_core(state, R_meas, t_meas, timestamp, cfg, meas_valid, k)[0]


def frame_step(state: EkfState, imu_t, imu_accel, imu_gyro, imu_valid, R_vo, t_vo, vo_valid,
               frame_t, cfg: EkfConfig, k: _Consts = None) -> EkfState:
    """Online per-frame fusion: predict at every valid sample of the
    padded IMU window, in order, then the VO update. imu_valid is a host
    mask (numpy or a CPU tensor): the reference's masked scan leaves the
    state as it is at an invalid sample, so only the valid ones run, and
    choosing them reads nothing from the device. The tensors lie on the
    state's device."""
    k = k or _Consts(cfg, state.P.dtype, state.P.device)
    for i in np.flatnonzero(np.asarray(imu_valid)):
        state = predict(state, imu_t[i], imu_accel[i], imu_gyro[i], cfg, k)
    return update(state, R_vo, t_vo, frame_t, cfg, vo_valid, k)


def _check_sorted(name, arr) -> None:
    """The merge is two binary searches over already sorted streams; an
    unsorted host array is refused (device tensors are not copied back
    to be checked)."""
    if isinstance(arr, np.ndarray) and arr.shape[0] > 1:
        d = np.diff(arr)
        if np.any(d < 0):
            raise ValueError(
                f"ekf.run_sequence: {name} is not sorted (first inversion at index "
                f"{int(np.argmax(d < 0))}); sort the streams by timestamp first "
                f"(io/euroc.py does)")


def merge_order(imu_t: torch.Tensor, vo_t: torch.Tensor) -> torch.Tensor:
    """merged index -> index into cat([imu, vo]) for two sorted streams;
    at equal timestamps the IMU samples come first."""
    m, v = imu_t.shape[0], vo_t.shape[0]
    dev = imu_t.device
    pos_imu = torch.arange(m, device=dev) + torch.searchsorted(vo_t, imu_t, right=False)
    pos_vo = torch.arange(v, device=dev) + torch.searchsorted(imu_t, vo_t, right=True)
    order = torch.empty(m + v, dtype=torch.int64, device=dev)
    order[torch.cat([pos_imu, pos_vo])] = torch.arange(m + v, device=dev)
    return order


@torch.inference_mode()
def run_sequence(imu_t, imu_accel, imu_gyro, vo_t, vo_R, vo_t_pos, cfg: EkfConfig,
                 smooth: bool = False, device=None, timer=None):
    """Offline fusion over whole streams: the 200 Hz IMU and the VO poses
    merged into one time-ordered event stream and filtered event by
    event; the fused pose at every VO timestamp. smooth=True adds the
    Rauch-Tung-Striebel backward pass over the error state (the causal
    filter lags its input; offline, the smoother uses the future too).

    imu_* (M, ...), vo_* (V, ...), float32, times in seconds. Host arrays
    or tensors; the filter runs on `device` (default: the device of
    `imu_accel` when it is a tensor, else the CPU). imu_t and vo_t must
    each be non-decreasing: host arrays are checked. timer: an optional
    utils.profiling.StageTimer, charged "ekf_forward" and "ekf_smoother".
    -> (pos (V, 3), quat (V, 4)) on that device."""
    _check_sorted("imu_t", imu_t)
    _check_sorted("vo_t", vo_t)
    if device is None:
        device = imu_accel.device if isinstance(imu_accel, torch.Tensor) else "cpu"

    imu_t, imu_accel, imu_gyro, vo_t, vo_R, vo_t_pos = (
        torch.as_tensor(x, device=device) for x in (imu_t, imu_accel, imu_gyro, vo_t, vo_R,
                                                    vo_t_pos))
    dtype = imu_t.dtype
    m, v = imu_t.shape[0], vo_t.shape[0]
    order = merge_order(imu_t, vo_t)
    all_t = torch.cat([imu_t, vo_t])[order]
    tags = torch.cat([torch.zeros(m, dtype=torch.int32, device=device),
                      torch.ones(v, dtype=torch.int32, device=device)])[order]
    payload_a = torch.cat([imu_accel, vo_t_pos])[order]
    payload_w = torch.cat([imu_gyro, torch.zeros((v, 3), dtype=imu_gyro.dtype,
                                                 device=device)])[order]
    payload_R = torch.cat([torch.eye(3, dtype=vo_R.dtype, device=device).expand(m, 3, 3),
                           vo_R])[order]
    # VO row -> its output slot; IMU rows go to a scratch slot v
    slot = torch.cat([torch.full((m,), v, dtype=torch.int64, device=device),
                      torch.arange(v, device=device)])[order]

    def stage(name):
        return timer.stage(name) if timer is not None else contextlib.nullcontext()

    k = _Consts(cfg, dtype, device)
    s = init_state(dtype, device)
    is_vo = tags.cpu().numpy() == 1  # the one host read: which step each event takes
    hist = {name: [] for name in ("pos", "quat", "P", "F", "dx", "barrier")}
    no_barrier = torch.tensor(False, device=device)
    with stage("ekf_forward"):
        for e in range(m + v):
            if is_vo[e]:
                s, dx, did_init = _update_core(s, payload_R[e], payload_a[e], all_t[e], cfg,
                                               True, k)
                F, barrier = k.eye15, did_init
            else:
                s, F = _predict_core(s, all_t[e], payload_a[e], payload_w[e], cfg, k)
                dx, barrier = k.zero15, no_barrier
            for name, x in (("pos", s.pos), ("quat", s.quat), ("P", s.P), ("F", F),
                            ("dx", dx), ("barrier", barrier)):
                hist[name].append(x)
        pos_hist, quat_hist = torch.stack(hist["pos"]), torch.stack(hist["quat"])
    if smooth:
        with stage("ekf_smoother"):
            pos_hist, quat_hist = _rts_backward(
                pos_hist, quat_hist, torch.stack(hist["P"]), torch.stack(hist["F"]),
                torch.stack(hist["dx"]), torch.stack(hist["barrier"]), tags)

    # the fused pose right after each VO update
    return vo_rows(pos_hist, slot, v), vo_rows(quat_hist, slot, v)


def vo_rows(hist: torch.Tensor, slot: torch.Tensor, v: int) -> torch.Tensor:
    """The merged stream's rows (N, D) at the VO slots: row e goes to slot
    e, where IMU rows carry slot v, the scratch row of a (v + 1)-row
    buffer. Every index is in range; nothing is read on the host."""
    out = torch.zeros((v + 1,) + hist.shape[1:], dtype=hist.dtype, device=hist.device)
    return out.index_copy_(0, slot, hist)[:v]


def _rts_backward(pos, quat, P, F, dx, barrier, tags):
    """RTS smoothing over the merged stream's error state. Per-event
    post-event inputs of the forward pass: P (N, 15, 15) posterior, F
    (N, 15, 15) the transition the event applied, dx (N, 15) the
    correction a VO update applied, barrier (N,) the initialisation
    event, tags (N,) 0 = IMU / 1 = VO. With delta_e the smoothed minus
    the filtered error at event e:

        delta_e = C_e (delta_{e+1} + dx_{e+1}),  delta_{N-1} = 0,

    and delta = 0 at the barrier, so no correction flows into the
    stretch before the filter started. The gains C_e = P+_e F_{e+1}^T
    (P-_{e+1})^-1 depend only on the forward pass, so they are solved for
    every event in one batched Cholesky solve. The prior P-_{e+1} is the
    stored posterior of event e + 1 when that is an IMU event (no update)
    and P+_e when it is a VO event (identity transition)."""
    P_prev = P[:-1]
    P_minus_next = torch.where((tags[1:] == 0)[:, None, None], P[1:], P_prev)
    A = P_prev @ F[1:].transpose(-1, -2)
    eps = torch.eye(15, dtype=P.dtype, device=P.device) * 1e-10  # float32 Cholesky floor
    # row j of C_e solves P-_{e+1} c_j = A_e[j] (P- is symmetric)
    C = cholesky_solve((P_minus_next + eps)[:, None], A)
    n = pos.shape[0]
    deltas = [torch.zeros(15, dtype=P.dtype, device=P.device)]
    for e in range(n - 2, -1, -1):
        d = C[e] @ (deltas[-1] + dx[e + 1])
        deltas.append(torch.where(barrier[e + 1], 0.0, d))
    deltas = torch.stack(deltas[::-1])
    pos_s = pos + deltas[:, 0:3]
    quat_s = lie.quat_normalize(lie.quat_mul(lie.so3_exp_quat(deltas[:, 6:9]), quat))
    return pos_s, quat_s
