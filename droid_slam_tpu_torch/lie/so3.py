"""SO(3) operations on quaternions ``[qx, qy, qz, qw]`` (scalar-last).

All functions broadcast over leading batch dimensions.  Small-angle
branches use Taylor expansions selected with ``torch.where`` on safe
operands, as in the JAX package.
"""

import torch

_EPS = 1e-8


def identity(shape=(), device=None, dtype=torch.float32):
    """Identity quaternion(s) of batch shape `shape` + (4,)."""
    q = torch.zeros(tuple(shape) + (4,), device=device, dtype=dtype)
    q[..., 3] = 1.0
    return q


def mul(q1, q2):
    """Hamilton product q1 ⊗ q2 (applying q2's rotation first)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack(
        [
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 + y1 * w2 + z1 * x2 - x1 * z2,
            w1 * z2 + z1 * w2 + x1 * y2 - y1 * x2,
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        ],
        dim=-1,
    )


def inv(q):
    """Inverse of a unit quaternion (conjugate)."""
    return torch.cat([-q[..., :3], q[..., 3:]], dim=-1)


def cross(a, b):
    """Cross product over the last axis, broadcasting like jnp.cross."""
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def act(q, v):
    """Rotate 3-vector(s) v by unit quaternion(s) q:
    v' = v + qw·uv + qv×uv with uv = 2 qv×v."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    uv = 2.0 * cross(qv, v)
    return v + qw * uv + cross(qv, uv)


def exp(phi):
    """SO(3) exponential map: rotation vector (...,3) -> quaternion (...,4)."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta_sq < 1e-8
    theta_safe = torch.sqrt(torch.where(small, torch.ones_like(theta_sq),
                                        theta_sq))
    imag_taylor = 0.5 - theta_sq / 48.0 + theta_sq * theta_sq / 3840.0
    real_taylor = 1.0 - theta_sq / 8.0 + theta_sq * theta_sq / 384.0
    imag = torch.where(small, imag_taylor,
                       torch.sin(0.5 * theta_safe) / theta_safe)
    real = torch.where(small, real_taylor, torch.cos(0.5 * theta_safe))
    return torch.cat([imag * phi, real], dim=-1)


def log(q):
    """SO(3) logarithm: quaternion (...,4) -> rotation vector (...,3)."""
    qv = q[..., :3]
    qw = q[..., 3:4]
    sign = torch.where(qw >= 0, 1.0, -1.0).to(q.dtype)
    qv = qv * sign
    qw = qw * sign
    norm_sq = torch.sum(qv * qv, dim=-1, keepdim=True)
    norm = torch.sqrt(torch.clamp(norm_sq, min=_EPS * _EPS))
    small = norm_sq < 1e-10
    angle = 2.0 * torch.atan2(norm, qw)
    qw_safe = torch.clamp(qw, min=_EPS)
    scale_taylor = 2.0 / qw_safe * (1.0 - norm_sq / (3.0 * qw_safe * qw_safe))
    scale = torch.where(small, scale_taylor, angle / norm)
    return scale * qv


def normalize(q):
    """Renormalize to a unit quaternion."""
    n = torch.linalg.norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def to_matrix(q):
    """Quaternion (...,4) -> rotation matrix (...,3,3)."""
    x, y, z, w = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(m.shape[:-1] + (3, 3))
