"""Dense damped Cholesky / Schur-complement solvers (training path).

Damping convention: ``H += (ep + lm·H)·I`` applied to the diagonal.  A
solve whose factorization fails or produces non-finite values returns a
zero update with zero gradients, as the JAX package's does.
"""

import torch


def _chol_solve(L, b):
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)


class _SolvePSD(torch.autograd.Function):
    """x = H⁻¹ b by Cholesky with the custom backward dL/db = H⁻¹ ḡ,
    dL/dH = −x (H⁻¹ ḡ)ᵀ; zero update and zero gradients on a failed
    factorization (autograd through a near-singular Cholesky emits NaN
    gradients, which poisons training)."""

    @staticmethod
    def forward(ctx, H, b):
        # cholesky_ex does not raise on a non-PD matrix: `info` > 0 marks
        # it, and the factor's contents are then unspecified
        L, info = torch.linalg.cholesky_ex(H)
        eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
        failed = (info != 0)[..., None, None]
        L = torch.where(failed, eye, L)
        x = _chol_solve(L, b)
        ok = ~failed & torch.isfinite(x).all(dim=(-2, -1), keepdim=True)
        x = torch.where(ok, x, torch.zeros_like(x))
        L = torch.where(ok, L, eye)
        ctx.save_for_backward(L, x, ok)
        return x

    @staticmethod
    def backward(ctx, g):
        L, x, ok = ctx.saved_tensors
        dz = _chol_solve(L, g)
        dz = torch.where(ok & torch.isfinite(dz), dz, torch.zeros_like(dz))
        dH = -torch.matmul(x, dz.transpose(-1, -2))
        return dH, dz


def solve_psd(H, b):
    """Solve H x = b for symmetric positive-definite H (..., n, n) and b
    (..., n, k), batched; see `_SolvePSD` for the failure and gradient
    rules."""
    return _SolvePSD.apply(H, b)


def _damp(H, ep, lm):
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return H + (ep + lm * H) * eye


def block_solve(H, b, ep=0.1, lm=1e-4):
    """Solve the block normal equations (motion-only BA).

    Args:
      H: (B, N, N, D, D) pose-pair Hessian blocks.
      b: (B, N, D) RHS.
    Returns:
      dx: (B, N, D).
    """
    B, N, _, D, _ = H.shape
    Hd = H.permute(0, 1, 3, 2, 4).reshape(B, N * D, N * D)
    Hd = _damp(Hd, ep, lm)
    x = solve_psd(Hd, b.reshape(B, N * D, 1))
    return x.reshape(B, N, D)


def schur_solve(H, E, C, v, w, ep=0.1, lm=1e-4, sless=False):
    """Solve the pose/depth system by dense Schur complement.

    Args:
      H: (B, P, P, D, D) pose Hessian blocks.
      E: (B, P, M, D, HW) pose–depth coupling blocks.
      C: (B, M, HW) depth diagonal (already damped by the caller's eta).
      v: (B, P, D) pose RHS.
      w: (B, M, HW) depth RHS.

    Returns:
      dx (B, P, D) and dz (B, M, HW) (dx alone with `sless`).
    """
    B, P, M, D, HW = E.shape
    Hd = H.permute(0, 1, 3, 2, 4).reshape(B, P * D, P * D)
    Ed = E.permute(0, 1, 3, 2, 4).reshape(B, P * D, M * HW)
    Q = (1.0 / C).reshape(B, M * HW, 1)

    Hd = _damp(Hd, ep, lm)
    vd = v.reshape(B, P * D, 1)
    wd = w.reshape(B, M * HW, 1)

    Et = Ed.transpose(1, 2)
    S = Hd - torch.matmul(Ed, Q * Et)
    rhs = vd - torch.matmul(Ed, Q * wd)

    dx = solve_psd(S, rhs)
    if sless:
        return dx.reshape(B, P, D)

    dz = Q * (wd - torch.matmul(Et, dx))
    return dx.reshape(B, P, D), dz.reshape(B, M, HW)
