"""Sim(3) operations on 8-vectors ``[tx,ty,tz,qx,qy,qz,qw,s]``.

Used by the scale-fitted geodesic training loss.  Tangent ordering is
``[τ (3), φ (3), σ (1)]`` — translation, rotation, log-scale.  Group
action on homogeneous points [Xv, W]: ``[s·R·Xv + W·t, W]``.  Every
function is differentiable; small-parameter branches are selected with
``torch.where`` on safe operands, as in the JAX package.
"""

import torch

from . import so3
from .so3 import cross

_EPS = 1e-8

DIM = 8
MANIFOLD_DIM = 7


def identity(shape=(), device=None, dtype=torch.float32):
    g = torch.zeros(tuple(shape) + (8,), device=device, dtype=dtype)
    g[..., 6] = 1.0
    g[..., 7] = 1.0
    return g


def t(g):
    return g[..., :3]


def q(g):
    return g[..., 3:7]


def s(g):
    return g[..., 7:8]


def make(trans, quat, scale):
    lead = torch.broadcast_shapes(trans.shape[:-1], quat.shape[:-1],
                                  scale.shape[:-1])
    return torch.cat([x.expand(lead + x.shape[-1:])
                      for x in (trans, quat, scale)], dim=-1)


def from_se3(g_se3):
    """Embed an SE(3) 7-vector with unit scale."""
    return torch.cat([g_se3, torch.ones_like(g_se3[..., :1])], dim=-1)


def scale_by(g, factor):
    """Left-multiply by a pure scaling element: (0, I, s) ∘ (t, R, σ) =
    (s·t, R, s·σ) — both the translation and the scale component are
    multiplied."""
    factor = torch.as_tensor(factor, dtype=g.dtype, device=g.device)
    factor = factor.expand(g[..., 7:8].shape)
    return torch.cat([g[..., :3] * factor, g[..., 3:7],
                      g[..., 7:8] * factor], dim=-1)


def mul(g1, g2):
    """(t1,R1,s1)∘(t2,R2,s2) = (s1 R1 t2 + t1, R1R2, s1 s2)."""
    q12 = so3.mul(q(g1), q(g2))
    t12 = s(g1) * so3.act(q(g1), t(g2)) + t(g1)
    return make(t12, q12, s(g1) * s(g2))


def inv(g):
    qi = so3.inv(q(g))
    si = 1.0 / torch.clamp(s(g), min=_EPS)
    ti = -si * so3.act(qi, t(g))
    return make(ti, qi, si)


def act(g, X):
    """Apply to homogeneous points [Xv, W]: [s R Xv + W t, W]."""
    Xv, W = X[..., :3], X[..., 3:4]
    Yv = s(g) * so3.act(q(g), Xv) + W * t(g)
    return torch.cat([Yv, W.expand(Yv.shape[:-1] + (1,))], dim=-1)


def _w_coeffs(phi, sigma):
    """Coefficients (A, B, C) of W = C·I + A·[φ]× + B·[φ]×²
    (trans = W τ in the Sim(3) exponential), all four small-parameter
    regimes handled with nested where."""
    theta_sq = torch.sum(phi * phi, dim=-1, keepdim=True)
    sg = sigma
    scale = torch.exp(sg)
    one = torch.ones_like(sg)

    sig_small = torch.abs(sg) < 1e-5
    th_small = theta_sq < 1e-10
    sg_safe = torch.where(sig_small, one, sg)
    th_safe = torch.sqrt(torch.where(th_small, one, theta_sq))

    C = torch.where(sig_small, 1.0 + sg / 2.0 + sg * sg / 6.0,
                    (scale - 1.0) / sg_safe)

    # σ≈0 branch
    A_s0 = torch.where(th_small, 0.5 * one,
                       (1.0 - torch.cos(th_safe))
                       / torch.clamp(theta_sq, min=_EPS))
    B_s0 = torch.where(th_small, one / 6.0,
                       (th_safe - torch.sin(th_safe))
                       / torch.clamp(theta_sq * th_safe, min=_EPS))

    # σ≠0 branch
    a_ = scale * torch.sin(th_safe)
    b_ = scale * torch.cos(th_safe)
    c_ = theta_sq + sg_safe * sg_safe
    A_t = (a_ * sg_safe + (1.0 - b_) * th_safe) \
        / torch.clamp(th_safe * c_, min=_EPS)
    B_t = (C - ((b_ - 1.0) * sg_safe + a_ * th_safe)
           / torch.clamp(c_, min=_EPS)) / torch.clamp(theta_sq, min=_EPS)
    # θ≈0, σ≠0
    A_t0 = ((sg_safe - 1.0) * scale + 1.0) \
        / torch.clamp(sg_safe * sg_safe, min=_EPS)
    B_t0 = (scale * (0.5 * sg_safe * sg_safe - sg_safe + 1.0) - 1.0) \
        / torch.clamp(sg_safe ** 3, min=_EPS)

    A = torch.where(sig_small, A_s0, torch.where(th_small, A_t0, A_t))
    B = torch.where(sig_small, B_s0, torch.where(th_small, B_t0, B_t))
    return A, B, C


def exp(xi):
    """Sim(3) exponential: (...,7) [τ, φ, σ] -> (...,8)."""
    tau, phi, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6:7]
    quat = so3.exp(phi)
    A, B, C = _w_coeffs(phi, sigma)
    c1 = cross(phi, tau)
    c2 = cross(phi, c1)
    trans = C * tau + A * c1 + B * c2
    return make(trans, quat, torch.exp(sigma))


def log(g):
    """Sim(3) logarithm: (...,8) -> (...,7) [τ, φ, σ]; τ solves W τ = t
    with the 3×3 W matrix."""
    phi = so3.log(q(g))
    sigma = torch.log(torch.clamp(s(g), min=_EPS))
    A, B, C = _w_coeffs(phi, sigma)
    px, py, pz = phi[..., 0], phi[..., 1], phi[..., 2]
    zeros = torch.zeros_like(px)
    hat = torch.stack(
        [zeros, -pz, py, pz, zeros, -px, -py, px, zeros], dim=-1
    ).reshape(phi.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=g.dtype, device=g.device)
    W = C[..., None] * eye + A[..., None] * hat + B[..., None] * (hat @ hat)
    tau = torch.linalg.solve(W, t(g)[..., None])[..., 0]
    return torch.cat([tau, phi, sigma], dim=-1)
