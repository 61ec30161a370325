"""IMU preintegration (counterpart of the JAX package's
fusion/preintegration.py).

Mid-point integration of (delta_p, delta_v, delta_q) between frames with
bias removal, dt gating (0 < dt <= max_dt) and 9x9 covariance propagation
over [dp, dv, dtheta]. Every field may carry leading batch axes: the
visual-inertial alignment integrates all frame pairs of a window
together, with one loop over the samples.
"""

from __future__ import annotations

import dataclasses

import torch

from aria_slam_tpu_torch.core import lie


@dataclasses.dataclass
class PreintState:
    delta_p: torch.Tensor   # (..., 3)
    delta_v: torch.Tensor   # (..., 3)
    delta_q: torch.Tensor   # (..., 4) (w, x, y, z)
    dt_sum: torch.Tensor    # (...)
    last_t: torch.Tensor    # (...): -1 before the first sample
    P: torch.Tensor         # (..., 9, 9) covariance over [dp, dv, dtheta]

    def replace(self, **changes) -> "PreintState":
        return dataclasses.replace(self, **changes)


def init_state(batch=(), dtype=torch.float32, device="cuda") -> PreintState:
    kw = dict(dtype=dtype, device=device)
    batch = tuple(batch)
    return PreintState(
        delta_p=torch.zeros(batch + (3,), **kw),
        delta_v=torch.zeros(batch + (3,), **kw),
        delta_q=lie.quat_identity(batch, dtype, device),
        dt_sum=torch.zeros(batch, **kw),
        last_t=torch.full(batch, -1.0, **kw),
        P=torch.zeros(batch + (9, 9), **kw),
    )


def integrate(state: PreintState, t, accel, gyro, accel_bias=None, gyro_bias=None,
              accel_noise: float = 0.01, gyro_noise: float = 0.001,
              max_dt: float = 0.5, covariance: bool = True) -> PreintState:
    """One measurement, gated on 0 < dt <= max_dt and on the first-sample
    bootstrap. covariance=False leaves P as it is (for a caller that reads
    only the deltas)."""
    a = accel if accel_bias is None else accel - accel_bias
    w = gyro if gyro_bias is None else gyro - gyro_bias

    dt = t - state.last_t
    ok = (state.last_t >= 0) & (dt > 0) & (dt <= max_dt)
    dt = torch.where(ok, dt, 0.0)
    dt1 = dt[..., None]

    # mid-point: rotate with the half-step orientation
    dq_half = lie.so3_exp_quat(w * dt1 * 0.5)
    q_half = lie.quat_normalize(lie.quat_mul(state.delta_q, dq_half))
    a_frame = lie.quat_rotate(q_half, a)

    delta_p = state.delta_p + state.delta_v * dt1 + 0.5 * a_frame * dt1 * dt1
    delta_v = state.delta_v + a_frame * dt1
    delta_q = lie.quat_normalize(lie.quat_mul(state.delta_q, lie.so3_exp_quat(w * dt1)))

    P = state.P
    if covariance:
        kw = dict(dtype=state.P.dtype, device=state.P.device)
        R = lie.quat_to_mat(state.delta_q)
        dt2 = dt[..., None, None]
        eye3 = torch.eye(3, **kw)
        F = torch.eye(9, **kw).expand(state.P.shape).clone()
        F[..., 0:3, 3:6] = eye3 * dt2
        F[..., 3:6, 6:9] = -R @ lie.skew(a) * dt2
        G = torch.zeros(state.P.shape[:-1] + (6,), **kw)
        G[..., 3:6, 0:3] = R * dt2
        G[..., 6:9, 3:6] = eye3 * dt2
        Q = torch.diag(torch.tensor([accel_noise**2] * 3 + [gyro_noise**2] * 3, **kw))
        P_new = F @ state.P @ F.transpose(-1, -2) + G @ Q @ G.transpose(-1, -2)
        P = torch.where(ok[..., None, None], P_new, state.P)

    return PreintState(
        delta_p=torch.where(ok[..., None], delta_p, state.delta_p),
        delta_v=torch.where(ok[..., None], delta_v, state.delta_v),
        delta_q=torch.where(ok[..., None], delta_q, state.delta_q),
        dt_sum=state.dt_sum + dt,
        last_t=t.expand(state.last_t.shape),
        P=P,
    )


def integrate_window(state: PreintState, ts, accels, gyros, valid,
                     accel_bias=None, gyro_bias=None, **kw) -> PreintState:
    """Fold a padded IMU window, samples along axis -1 of ts (..., M):
    a sample with valid False leaves the state as it is."""
    for k in range(ts.shape[-1]):
        new = integrate(state, ts[..., k], accels[..., k, :], gyros[..., k, :],
                        accel_bias, gyro_bias, **kw)
        v = valid[..., k]
        state = PreintState(**{
            f.name: torch.where(v.reshape(v.shape + (1,) * (getattr(new, f.name).dim() - v.dim())),
                                getattr(new, f.name), getattr(state, f.name))
            for f in dataclasses.fields(PreintState)})
    return state
