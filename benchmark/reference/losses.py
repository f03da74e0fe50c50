"""Training losses: geodesic pose loss, residual loss, flow loss.

γ-discounted sums over the unrolled update iterations, relative poses
over the training graph edges, optional monocular scale fitting via
Sim(3), and an optical-flow loss on temporally adjacent pairs.
"""

import math

import numpy as np
import torch

from . import se3, sim3, so3
from . import projective


def _norm(x, dim=-1):
    """L2 norm with a well-defined zero gradient at ‖x‖ = 0.

    The plain norm backpropagates x/‖x‖ = 0/0 = NaN at exactly-zero
    vectors — and padded edge slots (ii = jj = 0 ⇒ identity relative
    pose ⇒ zero twist) hit that every step; 0-mask × NaN is still NaN,
    so the whole gradient would be poisoned.
    """
    sq = torch.sum(x * x, dim=dim)
    nz = sq > 0
    return torch.sqrt(torch.where(nz, sq, torch.ones_like(sq))) * nz


def _relative(Gs, ii, jj):
    return se3.mul(Gs[:, jj], se3.inv(Gs[:, ii]))


def _fit_scale(Ps, Gs, ii, jj):
    """Per-batch least-squares scale between relative translations."""
    dP = _relative(Ps, ii, jj)
    dG = _relative(Gs, ii, jj)
    t1 = dP[..., :3].detach().reshape(dP.shape[0], -1)
    t2 = dG[..., :3].detach().reshape(dG.shape[0], -1)
    return (t1 * t2).sum(-1) / ((t2 * t2).sum(-1) + 1e-8)


def geodesic_loss(Ps, Gs_list, ii, jj, gamma=0.9, do_scale=True,
                  edge_mask=None):
    """γ-weighted relative-pose error over the graph.

    Args:
      Ps: (B, N, 7) ground-truth poses.
      Gs_list: list of (B, N, 7) per-iteration estimates, or a stacked
        (S, B, N, 7) tensor.
      ii, jj: (E,) long edge lists.
      edge_mask: optional (E,) validity for padded edge slots — masked
        means so padding never dilutes the loss.
    Returns (loss, metrics).
    """
    ii = torch.as_tensor(ii, device=Ps.device).long()
    jj = torch.as_tensor(jj, device=Ps.device).long()
    if edge_mask is None:
        edge_mask = torch.ones(ii.shape, dtype=torch.bool, device=Ps.device)
    m = torch.as_tensor(edge_mask, device=Ps.device).float()[None, :]
    denom = torch.clamp(m.sum(), min=1.0)

    def emean(x):
        """Masked mean over the (B, E) axes."""
        return (x * m).sum() / (denom * x.shape[0])

    dP = _relative(Ps, ii, jj)

    n = len(Gs_list)
    loss = 0.0
    for i, Gs in enumerate(Gs_list):
        w = gamma ** (n - i - 1)
        dG = _relative(Gs, ii, jj)

        if do_scale:
            s = _fit_scale(Ps, Gs, ii, jj)
            dGs = sim3.scale_by(sim3.from_se3(dG), s[:, None, None])
            dPs = sim3.from_se3(dP)
            dE = sim3.mul(dGs, sim3.inv(dPs))
            d = sim3.log(dE)
            tau, phi, sig = d[..., :3], d[..., 3:6], d[..., 6:]
            loss = loss + w * (emean(_norm(tau)) + emean(_norm(phi))
                               + 0.05 * emean(torch.abs(sig)[..., 0]))
        else:
            dE7 = se3.mul(dG, se3.inv(dP))
            d = se3.log(dE7)
            tau, phi = d[..., :3], d[..., 3:6]
            loss = loss + w * (emean(_norm(tau)) + emean(_norm(phi)))
            dE = sim3.from_se3(dE7)

    # metrics from the final iteration
    r_err = (180.0 / math.pi) * _norm(so3.log(dE[..., 3:7]))
    t_err = _norm(dE[..., :3])
    metrics = {
        "rot_error": emean(r_err),
        "tr_error": emean(t_err),
        "bad_rot": emean((r_err < 0.1).float()),
        "bad_tr": emean((t_err < 0.01).float()),
    }
    return loss, metrics


def residual_loss(residuals, gamma=0.9, edge_mask=None):
    """γ-weighted mean |residual|.

    Padded edges carry exact-zero residual rows; with edge_mask the mean
    is taken over valid edges only.
    """
    n = len(residuals)
    loss = 0.0
    for i, r in enumerate(residuals):
        term = torch.abs(r).mean()
        if edge_mask is not None:
            valid = torch.as_tensor(edge_mask, device=r.device).sum()
            term = term * (r.shape[1] / torch.clamp(valid.float(), min=1.0))
        loss = loss + gamma ** (n - i - 1) * term
    return loss, {"residual": loss}


def flow_loss(Ps, disps, poses_list, disps_list, intrinsics, gamma=0.9):
    """Optical-flow loss on |i−j| = 1 pairs; all inputs at one
    resolution."""
    N = Ps.shape[1]
    pairs = [(i, j) for i in range(N) for j in (i - 1, i + 1)
             if 0 <= j < N]
    ii = torch.as_tensor(np.asarray([p[0] for p in pairs]),
                         device=Ps.device).long()
    jj = torch.as_tensor(np.asarray([p[1] for p in pairs]),
                         device=Ps.device).long()

    coords0, val0 = projective.projective_transform(Ps, disps, intrinsics,
                                                    ii, jj)
    val0 = val0 * (disps[:, ii] > 0)[..., None]

    n = len(poses_list)
    loss = 0.0
    epe, v = None, None
    for i, (Gs, d_est) in enumerate(zip(poses_list, disps_list)):
        w = gamma ** (n - i - 1)
        coords1, val1 = projective.projective_transform(
            Gs, d_est, intrinsics, ii, jj)
        v = (val0 * val1)[..., 0]
        # guard BEFORE the norm: degenerate estimated depths can produce
        # non-finite reprojections on masked-out pixels, and a non-finite
        # input to the norm leaks NaN into the backward pass even when the
        # output is masked (0 · ∞ = NaN)
        diff = coords1 - coords0
        diff = torch.where(torch.isfinite(diff), diff,
                           torch.zeros_like(diff))
        epe = v * _norm(diff)
        loss = loss + w * epe.mean()

    denom = torch.clamp(v.sum(), min=1.0)
    f_error = (epe * v).sum() / denom
    one_px = ((epe < 1.0) * v).sum() / denom
    return loss, {"f_error": f_error, "1px": one_px}
