"""Visual-inertial alignment: metric scale, gravity and velocities from
preintegrated IMU aligned against up-to-scale visual odometry
(counterpart of the JAX package's fusion/vi_init.py).

For consecutive frames (i, i+1), with body preintegration (dp_i, dv_i
over dt_i, gravity-free, in the body frame at i) and the up-to-scale VO
positions pbar_i (world frame), the IMU kinematics

    s * (pbar_{i+1} - pbar_i) = v_i dt_i + 1/2 g dt_i^2 + R_wb_i dp_i
    v_{i+1} - v_i             = g dt_i + R_wb_i dv_i

are linear in the unknowns: one least-squares solve recovers the metric
scale s, the gravity vector g in the VO world frame and the velocities.
A second pass re-solves with |g| pinned to 9.81.

Split: the per-pair preintegration runs on the device, all pairs of a
window together with one loop over the samples
(fusion/preintegration.py); the least-squares system has about 50
unknowns and stays a float64 numpy solve on the host.

`ScaleEstimator` packages this as a sliding-window consumer for the
chunked evaluator: feed it each chunk's poses and the raw IMU stream,
read back a smoothed multiplicative correction for the VO scale chain
(1.0 = the chain is already metric).
"""

from __future__ import annotations

import numpy as np
import torch

from aria_slam_tpu_torch.fusion import preintegration

GRAVITY = 9.81


def _integrate_pairs_device(t0s, ts, accels, gyros, valid, gyro_bias, accel_bias, max_dt):
    """Preintegration of P padded sample windows together.

    t0s (P,): window-start (frame) times, the integration origin, so the
    first sample covers (t_i, ts_0]. Returns per-pair (dp (P, 3),
    dv (P, 3), dt_sum (P,)) in the body frame at t_i. The covariance is
    not propagated: nothing reads it here.
    """
    st = preintegration.init_state(t0s.shape, device=t0s.device).replace(last_t=t0s)
    st = preintegration.integrate_window(
        st, ts, accels, gyros, valid, accel_bias=accel_bias, gyro_bias=gyro_bias,
        max_dt=max_dt, covariance=False)
    return st.delta_p, st.delta_v, st.dt_sum


def preintegrate_pairs(imu_ts, imu_accel, imu_gyro, frame_ts,
                       gyro_bias=None, accel_bias=None,
                       max_samples: int = 160, min_samples: int = 2,
                       max_dt: float = 0.5, device="cuda"):
    """Preintegrate the IMU stream over every consecutive frame pair.

    imu_ts (M,) float64 seconds; imu_accel/imu_gyro (M, 3) body-frame
    specific force / rates; frame_ts (F,) frame times (same clock).
    Returns numpy (dp (F-1, 3), dv (F-1, 3), dts (F-1,), ok (F-1,)), body
    frame at the pair's first frame.

    The host slices the (t_i, t_{i+1}] windows into padded (P, samples)
    arrays, appending a virtual closing sample at t_{i+1} (zero-order
    hold of the last rate and force, the closure of
    fusion/gyro_prior.py); the device integrates all pairs together. A
    pair with more than max_samples samples is dropped. Times are
    re-based to frame_ts[0] in float64 before the float32 cast.
    """
    imu_ts = np.asarray(imu_ts, np.float64)
    frame_ts = np.asarray(frame_ts, np.float64)
    f = len(frame_ts)
    p = max(f - 1, 0)
    dp = np.zeros((p, 3), np.float32)
    dv = np.zeros((p, 3), np.float32)
    dts = np.zeros((p,), np.float32)
    ok = np.zeros((p,), bool)
    if p == 0 or len(imu_ts) == 0:
        return dp, dv, dts, ok

    t_base = frame_ts[0]
    ts_pad = np.zeros((p, max_samples), np.float32)
    a_pad = np.zeros((p, max_samples, 3), np.float32)
    w_pad = np.zeros((p, max_samples, 3), np.float32)
    v_pad = np.zeros((p, max_samples), bool)
    t0s = (frame_ts[:-1] - t_base).astype(np.float32)

    for i in range(p):
        t0, t1 = frame_ts[i], frame_ts[i + 1]
        if t1 <= t0:
            continue
        lo = int(np.searchsorted(imu_ts, t0, side="right"))
        hi = int(np.searchsorted(imu_ts, t1, side="right"))
        n = hi - lo
        if n < min_samples:
            continue
        close = imu_ts[hi - 1] < t1  # virtual sample at the frame time
        if n + int(close) > max_samples:
            # a partial integral paired with the full VO increment would
            # bias the solved scale: drop the pair
            continue
        ts_pad[i, :n] = imu_ts[lo:hi] - t_base
        a_pad[i, :n] = imu_accel[lo:hi]
        w_pad[i, :n] = imu_gyro[lo:hi]
        if close:
            ts_pad[i, n] = t1 - t_base
            a_pad[i, n] = imu_accel[hi - 1]
            w_pad[i, n] = imu_gyro[hi - 1]
        v_pad[i, :n + int(close)] = True
        ok[i] = True

    # the padding past the longest window never changes a state: cut it
    used = max(int(v_pad.sum(1).max()), 1)

    def dev(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(device)

    gb = None if gyro_bias is None else dev(np.asarray(gyro_bias, np.float32))
    ab = None if accel_bias is None else dev(np.asarray(accel_bias, np.float32))
    dpj, dvj, dtj = _integrate_pairs_device(
        dev(t0s), dev(ts_pad[:, :used]), dev(a_pad[:, :used]), dev(w_pad[:, :used]),
        dev(v_pad[:, :used]), gb, ab, max_dt)
    # one copy to the host for all three results
    packed = torch.cat([dpj.reshape(-1), dvj.reshape(-1), dtj.reshape(-1)]).cpu().numpy()
    dp = packed[: 3 * p].reshape(p, 3)
    dv = packed[3 * p: 6 * p].reshape(p, 3)
    dts = packed[6 * p:]
    ok = ok & (dts > 1e-6) & np.all(np.isfinite(dp), -1)
    return dp, dv, dts, ok


def _segments(ok, min_pairs: int = 3):
    """Contiguous runs of valid pairs (VO chain unbroken). Returns a
    list of index arrays; runs shorter than min_pairs are dropped (a
    2-pair segment's v0 freedom eats both rows)."""
    segs = []
    cur = []
    for i, o in enumerate(np.asarray(ok, bool)):
        if o:
            cur.append(i)
        elif cur:
            segs.append(np.asarray(cur))
            cur = []
    if cur:
        segs.append(np.asarray(cur))
    return [s for s in segs if len(s) >= min_pairs]


def _build_v0_system(vo_pos, R_wb, dp, dv, dts, ok, t_sel):
    """v0-CHAINED LS system (the ORB-SLAM3-style inertial-only
    alignment): per-frame velocities are eliminated EXACTLY by chaining
    them through the IMU velocity equation from one unknown v0 per
    contiguous segment,

        v_i = v0 + g (t_i - t0) + sum_{j<i} R_j dv_j,

    which substituted into each pair's position equation leaves

        s a_i = v0 dt_i + (1/2 dt_i^2 + dt_i (t_i - t0)) g
                + [R_i dp_i + dt_i S_i],     S_i = sum_{j<i} R_j dv_j,

    with a_i = pbar_{i+1} - pbar_i. Two earlier formulations measured
    WORSE on real VO: one free velocity per frame lets VO noise
    collapse s toward zero (s=0.006 on the depth-8 benchmark), and the
    velocity-eliminated triplet form (second differences of consecutive
    pairs) doubles the noise per row while splitting the signal across
    rows (residual 0.99, s scattered 1.9-3.1). The v0 chain keeps
    first-difference noise, couples every row of a segment through the
    same 7 global unknowns, and grows signal with the time offset from
    the segment start.

    REVERSE (errors-in-variables) arrangement: nearly all the noise is
    in the VO increments a_i (~60 deg direction noise at consecutive-
    frame baselines — the known information bound), while the IMU terms
    are orders quieter. Least squares is unbiased only when the noise
    sits in the RESIDUAL, not the regressors, so the solved system is

        a_i = beta C_i + dt_i v0'_k + D_i g'

    with beta = 1/s, v0' = v0/s, g' = g/s, C_i the bracketed IMU term
    and D_i its quadratic time factor: noisy VO on the LHS only.

    Returns (A (3M, 3*nseg + 4), b (3M,)) with unknown layout
    [v0'_0..v0'_{nseg-1} (3 each), g'(3), beta]."""
    segs = _segments(ok)
    nseg = len(segs)
    if nseg == 0:
        return np.zeros((0, 4)), np.zeros(0)
    nu = 3 * nseg + 4
    rows_A = []
    rows_b = []
    for k, seg in enumerate(segs):
        S = np.zeros(3)
        t0 = float(t_sel[seg[0]])
        for i in seg:
            dt = float(dts[i])
            C = R_wb[i] @ dp[i] + dt * S
            D = 0.5 * dt * dt + dt * (float(t_sel[i]) - t0)
            blk = np.zeros((3, nu))
            blk[:, 3 * k:3 * k + 3] = dt * np.eye(3)
            blk[:, -4:-1] = D * np.eye(3)
            blk[:, -1] = C
            rows_A.append(blk)
            rows_b.append(vo_pos[i + 1] - vo_pos[i])
            S = S + R_wb[i] @ dv[i]
    return np.concatenate(rows_A, 0), np.concatenate(rows_b, 0)


def _tangent_basis_np(g):
    a = np.array([1.0, 0.0, 0.0]) if abs(g[0]) < 0.7 else np.array(
        [0.0, 1.0, 0.0])
    b1 = np.cross(g, a)
    b1 /= max(np.linalg.norm(b1), 1e-12)
    b2 = np.cross(g, b1)
    return np.stack([b1, b2], -1)  # (3, 2)


def align(vo_pos, R_wb, dp, dv, dts, ok, refine_gravity: bool = True,
          t_sel=None):
    """Solve the linear visual-inertial alignment (v0-chained form).

    vo_pos (F, 3): up-to-scale VO positions (world frame);
    R_wb (F-1, 3, 3): world-from-BODY rotation at each pair's first
    frame (R_wc @ R_cam_imu); dp/dv/dts/ok: from preintegrate_pairs;
    t_sel (F,): frame times (defaults to the cumulative dts — exact
    when the pair set is gap-free).

    Returns a dict: s (metric scale multiplier for vo_pos), g (3,)
    gravity in the VO world frame, v (F, 3) world velocities
    (recovered by chaining each segment's solved v0 through the IMU),
    residual (row RMS normalized by the RMS right-hand side — on real
    VO this sits near 1.0 because the rows are noise-dominated; it is
    NOT the quality gate), g_err (| |g_free| - 9.81 | of the
    UNCONSTRAINED solve, m/s^2 — the self-consistency check: gravity
    norm is only recovered when the scale/gravity split is right),
    s_rel_std (relative 1-sigma of s from the LS covariance), n_pairs,
    excitation (RMS gravity-free acceleration variation, m/s^2 — scale
    is only observable when this is meaningfully nonzero), ok (gate).
    """
    f = len(vo_pos)
    n_pairs = int(np.sum(ok))
    out = {"s": 1.0, "g": np.array([0.0, 0.0, -GRAVITY]),
           "v": np.zeros((f, 3)), "residual": np.inf, "n_pairs": n_pairs,
           "excitation": 0.0, "s_rel_std": np.inf, "g_err": np.inf,
           "ok": False}
    if t_sel is None:
        t_sel = np.concatenate([[0.0], np.cumsum(np.asarray(dts))])
    A, b = _build_v0_system(vo_pos, R_wb, dp, dv, dts, ok, t_sel)
    nu = A.shape[1] if len(b) else 4
    nseg = (nu - 4) // 3
    if len(b) < nu + 8:  # enough rows beyond the unknown count
        return out

    # free solve: x = [v0'_k..., g'(3), beta]
    x, *_ = np.linalg.lstsq(A, b, rcond=None)
    beta = float(x[-1])
    if not np.isfinite(beta) or abs(beta) < 1e-6:
        return out
    s = 1.0 / beta
    g = x[-4:-1] * s
    out["g_err"] = abs(np.linalg.norm(g) - GRAVITY)

    # covariance source for the s_rel_std gate: the system actually
    # solved last (mixing the unconstrained normal matrix
    # with gravity-pinned residuals mismatches parameterizations/dof)
    A_c, x_c, beta_col = A, x, nu - 1
    if refine_gravity and np.linalg.norm(g) > 1e-6 and s > 0:
        # re-solve with |g| = G pinned: g' = beta*G*ghat + B w (w
        # absorbs beta in the tangent coords) -> stays LINEAR in
        # (v0', beta, w)
        for _ in range(2):
            ghat = g / max(np.linalg.norm(g), 1e-12)
            B = _tangent_basis_np(ghat)
            A2 = np.concatenate(
                [A[:, :-4],
                 (A[:, -1] + A[:, -4:-1] @ (GRAVITY * ghat))[:, None],
                 A[:, -4:-1] @ B], axis=1)
            x2, *_ = np.linalg.lstsq(A2, b, rcond=None)
            beta = float(x2[3 * nseg])
            if not np.isfinite(beta) or abs(beta) < 1e-6:
                return out
            s = 1.0 / beta
            gp = GRAVITY * beta * ghat + B @ x2[-2:]
            g = gp * s
            g = GRAVITY * g / max(np.linalg.norm(g), 1e-12)
        x = np.concatenate([x2[:3 * nseg], beta * g, [beta]])
        A_c, x_c, beta_col = A2, x2, 3 * nseg

    resid = A @ x - b
    out["s"] = s
    out["g"] = g
    out["residual"] = float(np.sqrt(np.mean(resid**2))
                            / max(np.sqrt(np.mean(b**2)), 1e-9))
    # relative 1-sigma of s from the LS covariance of the CONSTRAINED
    # system when gravity refinement ran (beta sits at column 3*nseg
    # there), else of the free system: the gate that keeps noisy
    # windows from steering the EMA
    resid_c = A_c @ x_c - b
    dof = max(len(b) - A_c.shape[1], 1)
    sigma2 = float(np.sum(resid_c**2)) / dof
    try:
        cov_bb = sigma2 * np.linalg.inv(A_c.T @ A_c)[beta_col, beta_col]
        out["s_rel_std"] = float(np.sqrt(max(cov_bb, 0.0)) / abs(beta))
    except np.linalg.LinAlgError:
        out["s_rel_std"] = np.inf
    # velocities: chain each segment's solved v0 through the IMU
    v = np.zeros((f, 3))
    for k, seg in enumerate(_segments(ok)):
        vk = s * x[3 * k:3 * k + 3]
        v[seg[0]] = vk
        for i in seg:
            vk = vk + g * float(dts[i]) + R_wb[i] @ dv[i]
            v[i + 1] = vk
    out["v"] = v
    # excitation: variation of the gravity-free world acceleration —
    # with constant acceleration (incl. zero) the scale column is
    # (nearly) in the span of the gravity column
    aw = np.stack([R_wb[i] @ dv[i] / max(float(dts[i]), 1e-3)
                   for i in np.flatnonzero(ok)])
    aw = aw + out["g"][None, :]
    out["excitation"] = float(np.std(np.linalg.norm(aw, axis=1))
                              + np.std(aw, axis=0).mean())
    out["ok"] = bool(np.isfinite(s) and 1e-3 < s < 1e3)
    return out


def _estimator_gates(rep, min_excitation, max_g_err,
                     max_s_rel_std: float = 0.45) -> bool:
    # NOT gated on `residual`: real VO rows are noise-dominated, so the
    # normalized residual sits near 1.0 even for a correct solve. The
    # quality signals are the free-gravity-norm self-check (g_err) and
    # the LS covariance of s itself (s_rel_std).
    return bool(rep["ok"]
                and rep["excitation"] >= min_excitation
                and rep.get("g_err", np.inf) <= max_g_err
                and rep.get("s_rel_std", np.inf) <= max_s_rel_std)


class ScaleEstimator:
    """Sliding-window metric-scale tracker for the chunked pipeline.

    Feed it, per chunk, the chunk's (timestamps, world-from-camera
    poses) AS PRODUCED by the scale chain, plus the raw IMU stream; it
    maintains the last `window` frames, re-runs the linear alignment,
    and exposes `correction()` — the CUMULATIVE multiplicative factor
    the scale chain must apply so its metric matches the IMU (1.0 when
    already metric).

    Two design points that matter (measured on the depth-8 benchmark
    scene, where the naive version spiraled to the 0.01 clip floor):

    1. WINDOW LENGTH over stride. The v0-chained system couples every
       pair of the window through 7 global unknowns, so the usable
       signal is the window's deviation-from-quadratic — it grows with
       the covered TIME span, not with per-pair baselines. On the
       depth-8 capture a 6.4 s window recovered s to ~1% consistently
       at strides 1-4, while any 3.2 s window scattered wildly
       (s_rel_std 1-4): prefer a long window at stride 1 (every pair
       adds rows; LS averages the noise) and gate out short fills.

    2. ABSOLUTE target, not residual integration. Each solve runs
       against the window rebuilt in the RAW chain metric (increments
       divided by the correction active when produced) and the EMA
       pulls the cumulative correction toward that absolute estimate.
       Integrating per-window RESIDUAL factors instead compounds any
       window-to-window bias every chunk — a death spiral; as an
       absolute target the same bias is a constant few-percent offset.

    Gated on pair count, acceleration excitation (scale is unobservable
    under constant velocity), the free-gravity-norm self-check, and the
    LS covariance of s; an unobservable window holds the last good
    correction.

    3. CONSENSUS before commitment. On low-excitation captures
       (rotation-dominant motion: excitation ~0.1 m/s^2) individual
       windows can pass the per-solve gates marginally yet scatter
       wildly (measured on the full-res rotloop: s = 0.26..1.02, one
       s_rel_std = 0.431 solve just under the 0.45 gate jumped the
       correction to 0.69 and pushed ATE 0.30 -> 0.39). The correction
       is therefore only COMMITTED once the recent passing solves,
       fused inverse-variance in log-s and inflated by their empirical
       overdispersion (reduced chi^2 — scattered solves claiming small
       sigmas do not fake agreement), pin log-s to better than
       `commit_rel_std`. One genuinely confident solve commits
       immediately (the VINS-style init jump survives); a string of
       mutually inconsistent marginal solves never does.

    A pose-graph rebase (loop closure) expresses subsequent poses in a
    different world frame — call `reset_window()` at that point (the
    cumulative correction survives; only the window restarts).
    """

    def __init__(self, R_cam_imu=None, window: int = 64, stride: int = 1,
                 ema: float = 0.35, min_excitation: float = 0.05,
                 max_g_err: float = 1.5, min_fill: float = 0.75,
                 commit_rel_std: float = 0.25, sigma_floor: float = 0.02,
                 hist_len: int = 8, device="cuda"):
        self.device = device
        self.R_cam_imu = (np.eye(3) if R_cam_imu is None
                          else np.asarray(R_cam_imu, np.float64))
        self.window = window
        self.stride = stride
        self.ema = ema
        self.min_excitation = min_excitation
        self.max_g_err = max_g_err
        self.min_fill = min_fill
        self.commit_rel_std = commit_rel_std
        self.sigma_floor = sigma_floor
        self.hist_len = hist_len
        self._ts: list = []      # frame times (float64 s)
        self._inc: list = []     # world increment from the previous frame
        self._tag: list = []     # correction active when appended
        self._Rwb: list = []     # (3,3) world-from-body per frame
        self._last_p = None
        self._corr = 1.0
        self._n_good = 0
        self._hist: list = []    # gate-passing (log s, sigma) solves
        self.last = None         # last align() report (diagnostics)

    def _consensus(self):
        """Fuse the solve history in log-s: inverse-variance mean, with
        the effective std the LARGER of (a) the posterior inflated by
        the reduced chi^2 and (b) the UN-shrunk weighted empirical
        scatter of the solves. (b) is what stops count from faking
        confidence: consecutive windows share ~75-95% of their frames,
        so solve errors are strongly correlated and do NOT average as
        1/sqrt(n) — five scattered marginal solves (the rotloop regime,
        s = 0.26..1.02 each claiming sigma ~0.4) must read as ~0.5
        uncertain, not 0.4/sqrt(5). Returns (mu, eff_std) or
        (None, inf) with an empty history."""
        if not self._hist:
            return None, np.inf
        ls = np.array([h[0] for h in self._hist])
        sg = np.array([h[1] for h in self._hist])
        w = 1.0 / sg**2
        mu = float(np.sum(w * ls) / np.sum(w))
        if len(ls) < 2:
            return mu, float(sg[0])
        chi2_red = float(np.sum(w * (ls - mu) ** 2) / (len(ls) - 1))
        post = float(np.sqrt(1.0 / np.sum(w))) * np.sqrt(max(1.0, chi2_red))
        emp = float(np.sqrt(np.sum(w * (ls - mu) ** 2) / np.sum(w)))
        return mu, max(post, emp)

    def reset_window(self):
        self._ts, self._inc, self._tag, self._Rwb = [], [], [], []
        self._last_p = None

    def rebase_scale(self, ratio: float):
        """The pipeline retroactively rescaled its whole recorded state
        by `ratio` (VINS-style metric rebase on a correction jump):
        re-express this window's produced-metric bookkeeping in the new
        metric. inc/tag scale together, so the RAW rebuild (inc / tag)
        is invariant — only the produced-metric quantities move."""
        self._last_p = None if self._last_p is None else self._last_p * ratio
        self._inc = [i * ratio for i in self._inc]
        self._tag = [t * ratio for t in self._tag]

    def update(self, frame_ts, poses, imu_ts, imu_accel, imu_gyro):
        """frame_ts (C,), poses (C, 4, 4) world-from-camera for the
        chunk's NEW frames; imu_*: the full (or covering) IMU stream.
        Returns the updated cumulative correction."""
        for t, T in zip(np.asarray(frame_ts, np.float64), poses):
            p = np.asarray(T[:3, 3], np.float64)
            inc = np.zeros(3) if self._last_p is None else p - self._last_p
            self._last_p = p
            self._ts.append(float(t))
            self._inc.append(inc)
            self._tag.append(self._corr)
            self._Rwb.append(np.asarray(T[:3, :3], np.float64)
                             @ self.R_cam_imu)
        if len(self._ts) > self.window:
            cut = len(self._ts) - self.window
            self._ts = self._ts[cut:]
            self._inc = self._inc[cut:]
            self._tag = self._tag[cut:]
            self._Rwb = self._Rwb[cut:]
        if len(self._ts) < max(int(self.min_fill * self.window),
                               5 * self.stride + 2):
            return self._corr  # short windows scatter (docstring #1)

        # rebuild the window in the RAW chain metric (divide each
        # increment by the correction active when it was produced),
        # subsampled at `stride` (see class docstring); always include
        # the newest frame
        inc_raw = np.stack(self._inc) / np.asarray(self._tag)[:, None]
        pos_all = np.cumsum(inc_raw, axis=0)
        n = len(self._ts)
        sel = list(range((n - 1) % self.stride, n, self.stride))
        pos = pos_all[sel]
        ts = np.asarray(self._ts)[sel]
        rwb = np.stack(self._Rwb)[sel]
        # pad to the steady-state selection size, as the reference does
        # (repeated last frame time => dt 0 => pair marked invalid,
        # excluded from every segment)
        nsel = self.window // self.stride + 1
        if len(sel) < nsel:
            padn = nsel - len(sel)
            pos = np.concatenate([pos, np.repeat(pos[-1:], padn, 0)])
            ts = np.concatenate([ts, np.repeat(ts[-1:], padn)])
            rwb = np.concatenate([rwb, np.repeat(rwb[-1:], padn, 0)])
        dp, dv, dts, ok = preintegrate_pairs(imu_ts, imu_accel, imu_gyro, ts,
                                             device=self.device)
        rep = align(pos, rwb[:-1], dp, dv, dts, ok, t_sel=ts - ts[0])
        self.last = rep
        if _estimator_gates(rep, self.min_excitation, self.max_g_err):
            # rep["s"] is the ABSOLUTE correction for the raw chain
            # (solve-to-solve comparable), so passing solves accumulate
            # into a consensus (class docstring #3) ...
            self._hist.append((float(np.log(max(rep["s"], 1e-6))),
                               max(float(rep["s_rel_std"]),
                                   self.sigma_floor)))
            self._hist = self._hist[-self.hist_len:]
            mu, eff = self._consensus()
            rep["consensus_s"] = None if mu is None else float(np.exp(mu))
            rep["consensus_rel_std"] = eff
            # ... and the correction moves only once that consensus is
            # tight. First commit JUMPS to the consensus (VINS-style
            # init — starting metrically wrong costs the whole early
            # trajectory), later solves smooth toward it.
            if eff <= self.commit_rel_std:
                alpha = 1.0 if self._n_good < 1 else self.ema
                self._n_good += 1
                self._corr = float(np.clip(
                    np.exp((1.0 - alpha) * np.log(self._corr)
                           + alpha * mu),
                    1e-2, 1e2))
        return self._corr

    def correction(self) -> float:
        """Cumulative multiplicative correction for the scale chain."""
        return self._corr
