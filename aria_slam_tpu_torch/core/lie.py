"""SO(3)/SE(3) operations, batched over leading axes (counterpart of the
JAX package's core/lie.py: same formulas, same Taylor guards, same
differentiation-safe norms, so autodiff through them is finite at the
identity).

SE3 matrices are 4x4, world-from-camera unless noted. Quaternions are
(w, x, y, z), Hamilton, unit norm.
"""

from __future__ import annotations

import torch

_EPS = 1e-8
# biases below f32 resolution keep sqrt/norm differentiable at 0
_TINY = 1e-24


def _safe_norm(v, dim=-1, keepdim=False):
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=keepdim) + _TINY)


def _eye(n, like):
    return torch.eye(n, dtype=like.dtype, device=like.device)


def cross(a, b):
    """Cross product over the last axis with broadcasting."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def skew(v):
    """(...,3) -> (...,3,3) cross-product matrix."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack(
        [
            torch.stack([zero, -z, y], -1),
            torch.stack([z, zero, -x], -1),
            torch.stack([-y, x, zero], -1),
        ],
        -2,
    )


# ----------------------------------------------------------------- quaternions
def quat_normalize(q):
    return q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)


def quat_identity(shape=(), dtype=torch.float32, device="cuda"):
    q = torch.zeros(tuple(shape) + (4,), dtype=dtype, device=device)
    q[..., 0] = 1.0
    return q


def quat_mul(a, b):
    aw, ax, ay, az = a[..., 0], a[..., 1], a[..., 2], a[..., 3]
    bw, bx, by, bz = b[..., 0], b[..., 1], b[..., 2], b[..., 3]
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        -1,
    )


def quat_rotate(q, v):
    """Rotate vectors (...,3) by unit quaternions (...,4)."""
    qv = q[..., 1:]
    w = q[..., :1]
    t = 2.0 * cross(qv, v)
    return v + w * t + cross(qv, t)


def quat_to_mat(q):
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    return torch.stack(
        [
            torch.stack([1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy)], -1),
            torch.stack([2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx)], -1),
            torch.stack([2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy)], -1),
        ],
        -2,
    )


def mat_to_quat(R):
    """(...,3,3) -> (...,4). Shepperd's method, branchless via where."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_TINY))

    qw0 = safe_sqrt(1.0 + tr) / 2.0
    s0 = torch.clamp(4.0 * qw0, min=_EPS)
    c0 = torch.stack([qw0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], -1)

    qx1 = safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    s1 = torch.clamp(4.0 * qx1, min=_EPS)
    c1 = torch.stack([(m21 - m12) / s1, qx1, (m01 + m10) / s1, (m02 + m20) / s1], -1)

    qy2 = safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    s2 = torch.clamp(4.0 * qy2, min=_EPS)
    c2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, qy2, (m12 + m21) / s2], -1)

    qz3 = safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    s3 = torch.clamp(4.0 * qz3, min=_EPS)
    c3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, qz3], -1)

    cond0 = tr > 0.0
    cond1 = (m00 > m11) & (m00 > m22)
    cond2 = m11 > m22
    q = torch.where(
        cond0[..., None],
        c0,
        torch.where(cond1[..., None], c1, torch.where(cond2[..., None], c2, c3)),
    )
    q = torch.where(q[..., :1] < 0, -q, q)  # canonical sign: w >= 0
    return quat_normalize(q)


# ----------------------------------------------------------------------- SO(3)
def so3_exp_quat(phi):
    """Rotation vector (...,3) -> quaternion (...,4)."""
    angle = _safe_norm(phi, keepdim=True)
    half = 0.5 * angle
    small = angle < 1e-6
    sinc_half = torch.where(small, 0.5 - angle**2 / 48.0,
                            torch.sin(half) / torch.clamp(angle, min=_EPS))
    return torch.cat([torch.cos(half), phi * sinc_half], -1)


def so3_log_quat(q):
    """Quaternion (...,4) -> rotation vector (...,3)."""
    q = torch.where(q[..., :1] < 0, -q, q)  # shortest arc
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vn = _safe_norm(v, keepdim=True)
    angle = 2.0 * torch.atan2(vn[..., 0], w)[..., None]
    small = vn < 1e-8
    scale = torch.where(small, 2.0 / torch.clamp(w[..., None], min=_EPS),
                        angle / torch.clamp(vn, min=_EPS))
    return v * scale


def so3_exp(phi):
    """Rotation vector (...,3) -> rotation matrix (...,3,3) (Rodrigues)."""
    angle = _safe_norm(phi)[..., None, None]
    K = skew(phi)
    K2 = K @ K
    small = angle < 1e-6
    a = torch.where(small, 1.0 - angle**2 / 6.0,
                    torch.sin(angle) / torch.clamp(angle, min=_EPS))
    b = torch.where(small, 0.5 - angle**2 / 24.0,
                    (1.0 - torch.cos(angle)) / torch.clamp(angle**2, min=_EPS))
    return _eye(3, phi).expand(K.shape) + a * K + b * K2


def so3_log(R):
    """Rotation matrix -> rotation vector (via quaternion, stable everywhere)."""
    return so3_log_quat(mat_to_quat(R))


# ----------------------------------------------------------------------- SE(3)
def se3_matrix(R, t):
    """(...,3,3),(...,3) -> (...,4,4)."""
    batch = torch.broadcast_shapes(R.shape[:-2], t.shape[:-1])
    R = R.expand(batch + (3, 3))
    t = t.expand(batch + (3,))
    top = torch.cat([R, t[..., None]], -1)
    bottom = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=R.dtype,
                          device=R.device).expand(batch + (4,))
    return torch.cat([top, bottom[..., None, :]], -2)


def se3_inverse(T):
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    Rt = R.transpose(-1, -2)
    return se3_matrix(Rt, -(Rt @ t[..., None])[..., 0])


def se3_exp(xi):
    """Twist (...,6) [rho, phi] -> (...,4,4)."""
    rho, phi = xi[..., :3], xi[..., 3:]
    R = so3_exp(phi)
    angle = _safe_norm(phi)[..., None, None]
    K = skew(phi)
    K2 = K @ K
    small = angle < 1e-6
    b = torch.where(small, 0.5 - angle**2 / 24.0,
                    (1.0 - torch.cos(angle)) / torch.clamp(angle**2, min=_EPS))
    c = torch.where(small, 1.0 / 6.0 - angle**2 / 120.0,
                    (angle - torch.sin(angle)) / torch.clamp(angle**3, min=_EPS))
    V = _eye(3, xi).expand(K.shape) + b * K + c * K2
    t = (V @ rho[..., None])[..., 0]
    return se3_matrix(R, t)


def se3_log(T):
    """(...,4,4) -> twist (...,6) [rho, phi]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    phi = so3_log(R)
    angle = _safe_norm(phi)[..., None, None]
    K = skew(phi)
    K2 = K @ K
    small = angle < 1e-6
    # V^{-1} = I - K/2 + coef * K^2
    coef = torch.where(
        small,
        1.0 / 12.0 + angle**2 / 720.0,
        (1.0 - angle * torch.cos(angle / 2.0)
         / torch.clamp(2.0 * torch.sin(angle / 2.0), min=_EPS))
        / torch.clamp(angle**2, min=_EPS),
    )
    Vinv = _eye(3, phi).expand(K.shape) - 0.5 * K + coef * K2
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, phi], -1)
