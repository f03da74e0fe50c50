"""SE(3) operations on 7-vectors ``[tx, ty, tz, qx, qy, qz, qw]``.

Conventions (the JAX package's, which match the reference):
  * tangent vectors are ``[τ (translation), φ (rotation)]``;
  * ``retr(g, ξ) = exp(ξ) ∘ g`` (left retraction);
  * ``adjT(g, a) = Ad_gᵀ a`` — the dual adjoint of the pose-i Jacobian;
  * group elements act on homogeneous points ``[X, Y, Z, W]``
    (W = inverse depth): ``g · X = [R·Xv + W·t, W]``.
"""

import torch

from . import so3
from .so3 import cross

_EPS = 1e-8


def identity(shape=(), device=None, dtype=torch.float32):
    g = torch.zeros(tuple(shape) + (7,), device=device, dtype=dtype)
    g[..., 6] = 1.0
    return g


def t(g):
    return g[..., :3]


def q(g):
    return g[..., 3:7]


def make(trans, quat):
    trans, quat = _bcast_lead(trans, quat)
    return torch.cat([trans, quat], dim=-1)


def _bcast_lead(a, b):
    lead = torch.broadcast_shapes(a.shape[:-1], b.shape[:-1])
    return (a.expand(lead + a.shape[-1:]), b.expand(lead + b.shape[-1:]))


def mul(g1, g2):
    """Group composition g1 ∘ g2."""
    q12 = so3.mul(q(g1), q(g2))
    t12 = so3.act(q(g1), t(g2)) + t(g1)
    return make(t12, q12)


def inv(g):
    qi = so3.inv(q(g))
    ti = -so3.act(qi, t(g))
    return make(ti, qi)


def act(g, X):
    """Apply to homogeneous points X (...,4) = [Xv, W]: [R Xv + W t, W]."""
    Xv, W = X[..., :3], X[..., 3:4]
    Yv = so3.act(q(g), Xv) + W * t(g)
    Yv, W = _bcast_lead(Yv, W)
    return torch.cat([Yv, W], dim=-1)


def _v_matrix_terms(phi):
    """Coefficients (a, b) of V = I + a [φ]× + b [φ]×² with Taylor fallback."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta_sq < 1e-8
    one = torch.ones_like(theta_sq)
    theta_safe = torch.sqrt(torch.where(small, one, theta_sq))
    a = torch.where(
        small,
        0.5 - theta_sq / 24.0,
        (1.0 - torch.cos(theta_safe)) / torch.where(small, one, theta_sq),
    )
    b = torch.where(
        small,
        1.0 / 6.0 - theta_sq / 120.0,
        (theta_safe - torch.sin(theta_safe))
        / torch.where(small, one, theta_sq * theta_safe),
    )
    return a, b


def exp(xi):
    """SE(3) exponential: twist (...,6) [τ, φ] -> group element (...,7)."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    quat = so3.exp(phi)
    a, b = _v_matrix_terms(phi)
    c1 = cross(phi, tau)
    c2 = cross(phi, c1)
    trans = tau + a * c1 + b * c2
    return make(trans, quat)


def log(g):
    """SE(3) logarithm: group element (...,7) -> twist (...,6) [τ, φ]."""
    phi = so3.log(q(g))
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    small = theta_sq < 1e-8
    one = torch.ones_like(theta_sq)
    theta_safe = torch.sqrt(torch.where(small, one, theta_sq))
    half = 0.5 * theta_safe
    cot_term = half * torch.cos(half) / torch.clamp(torch.sin(half), min=_EPS)
    c = torch.where(
        small,
        1.0 / 12.0 + theta_sq / 720.0,
        (1.0 - cot_term) / torch.where(small, one, theta_sq),
    )
    tv = t(g)
    c1 = cross(phi, tv)
    c2 = cross(phi, c1)
    tau = tv - 0.5 * c1 + c * c2
    return torch.cat([tau, phi], dim=-1)


def retr(g, xi):
    """Left retraction exp(ξ) ∘ g, quaternion renormalized."""
    out = mul(exp(xi), g)
    return make(t(out), so3.normalize(q(out)))


def adjT(g, a):
    """Dual adjoint Ad_gᵀ a for covectors a (...,6) [av, aw]:
    out_v = R⁻¹ av, out_w = R⁻¹ aw + R⁻¹ (av × t)."""
    qi = so3.inv(q(g))
    av, aw = a[..., :3], a[..., 3:6]
    ov = so3.act(qi, av)
    ow = so3.act(qi, aw + cross(av, t(g)))
    return torch.cat([ov, ow], dim=-1)


def adj(g, xi):
    """Adjoint Ad_g ξ for twists ξ (...,6): (R τ + t × R φ, R φ)."""
    tau, phi = xi[..., :3], xi[..., 3:6]
    rphi = so3.act(q(g), phi)
    rtau = so3.act(q(g), tau)
    return torch.cat([rtau + cross(t(g), rphi), rphi], dim=-1)


def matrix(g):
    """4×4 homogeneous matrix (...,4,4)."""
    R = so3.to_matrix(q(g))
    tv = t(g)
    top = torch.cat([R, tv[..., :, None]], dim=-1)
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def interp(g0, g1, alpha):
    """Geodesic interpolation exp(α · log(g1 ∘ g0⁻¹)) ∘ g0."""
    dg = mul(g1, inv(g0))
    return mul(exp(alpha * log(dg)), g0)
