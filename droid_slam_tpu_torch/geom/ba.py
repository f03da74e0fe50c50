"""Differentiable dense bundle adjustment (training path).

One damped Gauss-Newton step over keyframe poses and per-pixel inverse
depth, built from the projective-transform Jacobians and solved with a
dense Schur complement, in float32.  Fully differentiable: training
backpropagates through this and the retraction.

Edge lists are padded to a fixed capacity; padded slots must carry zero
weight.  Depth rows are per frame (M = P), so frames without edges get a
pure-damping row and a zero update.
"""

import torch

from ..lie import se3
from ..ops import scatter
from . import projective
from .chol import block_solve, schur_solve

# residual weighting applied inside BA
_W_SCALE = 0.001
# per-pixel depth damping floor
_EP_DEPTH = 1e-7


def _as_edges(ii, jj, device):
    ii = torch.as_tensor(ii, device=device).reshape(-1).long()
    jj = torch.as_tensor(jj, device=device).reshape(-1).long()
    return ii, jj


def _scatter_mat(A, ii, jj, n, m):
    """Sum per-edge blocks A (B, E, ...) into an (n, m) block grid
    (B, n, m, ...); out-of-range (fixed-pose) indices are dropped."""
    v = (ii >= 0) & (jj >= 0) & (ii < n) & (jj < m)
    idx = torch.where(v, ii * m + jj, n * m)        # n*m = drop bucket
    out = A.new_zeros((A.shape[0], n * m + 1) + A.shape[2:])
    out = scatter.index_add_(out, 1, idx, A)[:, :-1]
    return out.reshape((A.shape[0], n, m) + A.shape[2:])


def _scatter_vec(b, ii, n):
    v = (ii >= 0) & (ii < n)
    idx = torch.where(v, ii, n)
    out = b.new_zeros((b.shape[0], n + 1) + b.shape[2:])
    return scatter.index_add_(out, 1, idx, b)[:, :-1]


def _linearize(target, weight, poses, disps, intrinsics, ii, jj):
    """Weighted GN blocks for every edge: Hii/Hij/Hji/Hjj (B,E,6,6),
    vi/vj (B,E,6), Ei/Ej (B,E,6,HW), Ck/wk (B,E,HW)."""
    B, E = target.shape[:2]
    ht, wd = disps.shape[-2:]
    HW = ht * wd

    coords, valid, (Ji, Jj, Jz) = projective.projective_transform(
        poses, disps, intrinsics, ii, jj, jacobian=True)

    r = (target - coords).reshape(B, E, HW * 2, 1)
    w = (_W_SCALE * valid * weight).reshape(B, E, HW * 2, 1)
    # padded-edge targets can be arbitrary; w is zero there, keep products
    # finite
    r = torch.where(torch.isfinite(r), r, torch.zeros_like(r))

    Ji = Ji.reshape(B, E, HW * 2, 6)
    Jj = Jj.reshape(B, E, HW * 2, 6)
    Jz = Jz.reshape(B, E, HW, 2)

    wJi = w * Ji
    wJj = w * Jj

    def blk(a, b):
        return torch.einsum("benk,benl->bekl", a, b)

    Hii, Hij = blk(wJi, Ji), blk(wJi, Jj)
    Hji, Hjj = blk(wJj, Ji), blk(wJj, Jj)
    vi = torch.einsum("benk,beno->bek", wJi, r)
    vj = torch.einsum("benk,beno->bek", wJj, r)

    # pose–depth coupling: contract the 2 residual channels against Jz
    wJi_px = wJi.reshape(B, E, HW, 2, 6)
    wJj_px = wJj.reshape(B, E, HW, 2, 6)
    Ei = torch.einsum("bepck,bepc->bekp", wJi_px, Jz)
    Ej = torch.einsum("bepck,bepc->bekp", wJj_px, Jz)

    w_px = w.reshape(B, E, HW, 2)
    r_px = r.reshape(B, E, HW, 2)
    Ck = torch.sum(w_px * Jz * Jz, dim=-1)
    wk = torch.sum(w_px * r_px * Jz, dim=-1)

    return Hii, Hij, Hji, Hjj, vi, vj, Ei, Ej, Ck, wk


def _pose_system(blocks, iio, jjo, Pp):
    Hii, Hij, Hji, Hjj, vi, vj = blocks[:6]
    H = (_scatter_mat(Hii, iio, iio, Pp, Pp)
         + _scatter_mat(Hij, iio, jjo, Pp, Pp)
         + _scatter_mat(Hji, jjo, iio, Pp, Pp)
         + _scatter_mat(Hjj, jjo, jjo, Pp, Pp))
    v = _scatter_vec(vi, iio, Pp) + _scatter_vec(vj, jjo, Pp)
    return H, v


def _retract_poses(poses, dx, fixedp):
    """exp(dx) ∘ pose for the optimized poses; the first `fixedp` (and
    any beyond the optimized window) stay."""
    B, P = poses.shape[:2]
    Pp = dx.shape[1]
    dx_full = torch.cat([dx.new_zeros((B, fixedp, 6)), dx,
                         dx.new_zeros((B, P - fixedp - Pp, 6))], dim=1)
    return se3.retr(poses, dx_full)


def ba(target, weight, eta, poses, disps, intrinsics, ii, jj,
       fixedp=1, rig=1, ep=0.1, lm=1e-4):
    """One full bundle-adjustment step.

    Args:
      target, weight: (B, E, H, W, 2).  Padded edge slots must carry zero
        weight.
      eta: (B, P, H, W) per-pixel, per-frame depth damping.
      poses: (B, P, 7); disps: (B, P, H, W); intrinsics: (B, P, 4).
      ii, jj: (E,) edge lists.
      fixedp: number of anchored poses at the start of the window.

    Returns updated (poses, disps).
    """
    ii, jj = _as_edges(ii, jj, poses.device)
    B, P = poses.shape[:2]
    ht, wd = disps.shape[-2:]
    HW = ht * wd

    blocks = _linearize(target, weight, poses, disps, intrinsics, ii, jj)
    Ei, Ej, Ck, wk = blocks[6:]

    # only optimize keyframe poses (drop the first `fixedp`)
    Pp = P // rig - fixedp
    iio = ii // rig - fixedp
    jjo = jj // rig - fixedp
    kk = ii // rig                       # depth row of the source frame
    M = P // rig

    H, v = _pose_system(blocks, iio, jjo, Pp)
    E_mat = (_scatter_mat(Ei, iio, kk, Pp, M)
             + _scatter_mat(Ej, jjo, kk, Pp, M))
    C = _scatter_vec(Ck, kk, M)
    w = _scatter_vec(wk, kk, M)

    C = C + eta.reshape(B, M, HW) + _EP_DEPTH

    dx, dz = schur_solve(H, E_mat, C, v, w, ep=ep, lm=lm)

    poses = _retract_poses(poses, dx, fixedp)
    # depth rows are per frame (kk = ii // rig): the first M = P // rig
    # rows take dz; for rig = 1 that is the whole buffer
    disps = torch.cat([disps[:, :M] + dz.reshape(B, M, ht, wd),
                       disps[:, M:]], dim=1)

    disps = torch.where(disps > 10.0, torch.zeros_like(disps), disps)
    disps = torch.clamp(disps, min=0.0)
    return poses, disps


def moba(target, weight, poses, disps, intrinsics, ii, jj,
         fixedp=1, rig=1, ep=0.1, lm=1e-4):
    """Motion-only bundle adjustment: returns the updated poses."""
    ii, jj = _as_edges(ii, jj, poses.device)
    P = poses.shape[1]

    blocks = _linearize(target, weight, poses, disps, intrinsics, ii, jj)

    Pp = P // rig - fixedp
    iio = ii // rig - fixedp
    jjo = jj // rig - fixedp

    H, v = _pose_system(blocks, iio, jjo, Pp)
    dx = block_solve(H, v, ep=ep, lm=lm)
    return _retract_poses(poses, dx, fixedp)
