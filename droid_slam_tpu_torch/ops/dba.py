"""Dense bundle adjustment over poses and per-pixel inverse depth.

Damped Gauss-Newton with the depth unknowns eliminated by Schur
complement and a dense Cholesky pose solve, all in float32 on the
tensors' device.  Index plumbing (edge → pose slot, edge → depth frame,
depth frame → buffer row) is gather and `ops/scatter.index_add_` (a sum
order that repeats on the card), where the JAX package contracts 0/1
selector matrices on the TPU's matrix unit.

Semantics kept from the JAX package (and the reference kernel):
  * weights scaled by 0.001 and zeroed where the transformed depth is
    below MIN_DEPTH;
  * stereo (ii == jj) edges contribute only to the depth diagonal/RHS;
  * RGB-D prior: C += α·m, w -= α·m·(disp − disp_sens), α = 0.05;
  * damping `diag += ep + lm·diag`; a solve with a failed factorization
    or non-finite result gives a zero pose update;
  * poses outside [t0, t0 + P) ∩ [t0, t1) are fixed (every buffer pose
    still goes through the retraction with a zero update, which
    renormalizes its quaternion); depth updates cover the depth-frame
    list kx; all disparities are clamped to ≥ 0.001 afterwards.

The Schur complement is assembled per depth frame k from its coupling
terms — one self term Σ_e Eii at pose kx[k] and one Eij term per edge
leaving k at pose jj — as S = Σ_k Σ_{a,b} B_a Q_k B_bᵀ over pairs of
terms that share k.
"""

import numpy as np
import torch

from ..geom import projective
from ..lie import se3
from ..utils.timers import sync_site
from . import scatter

ALPHA = 0.05          # RGB-D prior strength
W_SCALE = 0.001       # residual weight scale
LIN_CHUNK = 512       # edges per linearization pass


def build_schur_tables(ii, edge_mask, t0, t1, K):
    """Depth-frame list kx = unique([t0, t1) ∪ ii[edge_mask]) padded to
    K (numpy).  Raises if more than K frames are needed."""
    ii = np.asarray(ii)
    edge_mask = np.asarray(edge_mask, bool)
    frames = np.unique(np.concatenate([np.arange(t0, t1), ii[edge_mask]]))
    if len(frames) > K:
        raise ValueError(
            f"depth-frame count {len(frames)} exceeds cap {K}: raise "
            f"SLAMConfig.frontend_depth_cap for this window/graph size")
    kx = np.zeros(K, np.int64)
    kmask = np.zeros(K, bool)
    kx[: len(frames)] = frames
    kmask[: len(frames)] = True
    return kx, kmask


def _linearize(poses, disps, intrinsics, target, weight, ii, jj):
    """Per-edge weighted GN blocks for valid edges.

    Returns Hblk (E,2,6,2,6) for the [ξi; ξj] system, v (E,2,6),
    Eii/Eij (E,6,HW), Cii/wi (E,HW).
    """
    E = ii.shape[0]
    ht, wd = disps.shape[-2:]
    HW = ht * wd

    coords, valid, (Ji, Jj, Jz) = projective.projective_transform(
        poses[None], disps[None], intrinsics[None], ii, jj, jacobian=True)
    coords, valid = coords[0], valid[0]
    Ji, Jj, Jz = Ji[0], Jj[0], Jz[0]

    r = (target - coords).reshape(E, HW * 2)
    w = W_SCALE * (valid * weight).reshape(E, HW * 2)
    w_pose = w * (ii != jj)[:, None].to(w.dtype)

    J = torch.cat([Ji.reshape(E, HW * 2, 6), Jj.reshape(E, HW * 2, 6)],
                  dim=-1)                                   # (E, HW2, 12)
    wJ = w_pose[..., None] * J
    Hblk = torch.einsum("enk,enl->ekl", wJ, J)
    v = torch.einsum("enk,en->ek", wJ, r)

    Jz = Jz.reshape(E, HW, 2)
    wp_px = w_pose.reshape(E, HW, 2)
    w_px = w.reshape(E, HW, 2)
    r_px = r.reshape(E, HW, 2)
    Eii = torch.einsum("epc,epck->ekp", wp_px * Jz, Ji.reshape(E, HW, 2, 6))
    Eij = torch.einsum("epc,epck->ekp", wp_px * Jz, Jj.reshape(E, HW, 2, 6))
    Cii = torch.sum(w_px * Jz * Jz, dim=-1)
    wi = torch.sum(w_px * r_px * Jz, dim=-1)
    return Hblk.reshape(E, 2, 6, 2, 6), v.reshape(E, 2, 6), Eii, Eij, Cii, wi


def _linearize_chunked(poses, disps, intrinsics, target, weight, ii, jj):
    outs = [_linearize(poses, disps, intrinsics, target[lo:lo + LIN_CHUNK],
                       weight[lo:lo + LIN_CHUNK], ii[lo:lo + LIN_CHUNK],
                       jj[lo:lo + LIN_CHUNK])
            for lo in range(0, ii.shape[0], LIN_CHUNK)]
    return tuple(torch.cat(x, dim=0) for x in zip(*outs))


def _slot(idx, n):
    """Map indices outside [0, n) to the dump slot n."""
    return torch.where((idx >= 0) & (idx < n), idx, torch.full_like(idx, n))


def edge_problem(ii, jj, edge_mask, target, weight, kx, kmask, disps_sens,
                 eta, t0, P):
    """The index plumbing of one BA problem, fixed across its iterations:
    the masked edges and their pose slots (P = outside the window), the
    depth frames kx (K = not one) with their sensor disparities and
    damping."""
    dev = target.device
    buf = disps_sens.shape[0]
    HW = disps_sens.shape[1] * disps_sens.shape[2]
    K = kx.shape[0]

    with sync_site("ba.edges"):
        sel = torch.nonzero(edge_mask).squeeze(1)
    ii, jj = ii[sel].long(), jj[sel].long()
    pi, pj = _slot(ii - t0, P), _slot(jj - t0, P)
    pe = torch.stack([pi, pj], dim=1)                       # (E, 2)

    kx = kx.long()
    slot_of = torch.full((buf + 1,), K, dtype=torch.long, device=dev)
    ar = torch.arange(K, device=dev)
    slot_of[torch.where(kmask, kx, torch.full_like(kx, buf))] = torch.where(
        kmask, ar, torch.full_like(ar, K))
    with sync_site("h2d.const"):
        slot_of[buf] = K
    dsk = disps_sens[kx].reshape(K, HW)
    return dict(
        ii=ii, jj=jj, target=target[sel].float(), weight=weight[sel].float(),
        pe=pe, pj=pj,
        blk_idx=(pe[:, :, None] * (P + 1) + pe[:, None, :]).reshape(-1),
        kx=kx, kmask=kmask, ar=ar, ks=slot_of[ii],          # (E,) K = none
        ps=_slot(torch.where(kmask, kx - t0, torch.full_like(kx, -1)), P),
        dsk=dsk, eta_k=eta[kx].reshape(K, HW), m_sens=(dsk > 0).float(),
        P=P)


def pose_system(prob, poses, disps, intrinsics, motion_only=False):
    """Linearize the problem's edges at (poses, disps) and eliminate its
    depth frames: returns the pose system H − S as (P+1)² blocks of 6×6
    (row and column P collect the fixed poses), v − vs as (P+1, 6), and
    the depth terms `depth_update` needs (None under motion_only)."""
    dev = poses.device
    P = prob["P"]
    ii, jj = prob["ii"], prob["jj"]
    E = ii.shape[0]
    K = prob["kx"].shape[0]
    HW = disps.shape[-2] * disps.shape[-1]

    lin = _linearize if E <= LIN_CHUNK else _linearize_chunked
    Hblk, v, Eii, Eij, Cii, wi = lin(poses, disps, intrinsics,
                                     prob["target"], prob["weight"], ii, jj)

    # pose system, (P+1)² blocks with a dump row/col for fixed poses
    H4 = torch.zeros(((P + 1) * (P + 1), 6, 6), device=dev)
    scatter.index_add_(H4, 0, prob["blk_idx"],
                       Hblk.permute(0, 1, 3, 2, 4).reshape(E * 4, 6, 6))
    vd = torch.zeros((P + 1, 6), device=dev)
    scatter.index_add_(vd, 0, prob["pe"].reshape(-1), v.reshape(E * 2, 6))
    if motion_only:
        return H4, vd, None

    ks, kmask, m_sens = prob["ks"], prob["kmask"], prob["m_sens"]
    dk = disps[prob["kx"]].reshape(K, HW)
    C = scatter.index_add_(torch.zeros((K + 1, HW), device=dev), 0, ks, Cii)
    w = scatter.index_add_(torch.zeros((K + 1, HW), device=dev), 0, ks, wi)
    C = C[:K] + m_sens * ALPHA + (1.0 - m_sens) * prob["eta_k"]
    w = w[:K] - m_sens * ALPHA * (dk - prob["dsk"])
    Q = torch.where(kmask[:, None], 1.0 / C, torch.zeros_like(C))
    E_self = torch.zeros((K + 1, 6, HW), device=dev)
    E_self = scatter.index_add_(E_self, 0, ks, Eii)[:K]

    # coupling terms: K self terms, then one Eij term per edge
    B = torch.cat([E_self, Eij], dim=0)                     # (T, 6, HW)
    tk = torch.cat([prob["ar"], ks])                        # K = none
    tp = torch.cat([prob["ps"], prob["pj"]])                # P = fixed
    live = (tk < K) & (tp < P)
    with sync_site("ba.pairs"):
        pa, pb = torch.nonzero(
            (tk[:, None] == tk[None, :]) & live[:, None] & live[None, :],
            as_tuple=True)
    tkq = tk.clamp(max=K - 1)     # dead terms: any row, masked
    BQ = B * Q[tkq][:, None, :]
    chunk = max(256, int(2e8 // (6 * HW * 4 * 2)))
    for lo in range(0, pa.shape[0], chunk):
        a, b = pa[lo:lo + chunk], pb[lo:lo + chunk]
        S_ab = torch.bmm(BQ[a], B[b].transpose(1, 2))
        scatter.index_add_(H4, 0, tp[a] * (P + 1) + tp[b], -S_ab)
    vs = torch.einsum("tah,th->ta", B, Q[tkq] * w[tkq])
    vs = torch.where(live[:, None], vs, torch.zeros_like(vs))
    scatter.index_add_(vd, 0, tp, -vs)
    return H4, vd, dict(B=B, Q=Q, w=w, tk=tk, tp=tp)


def solve_poses(H4, vd, P, ep, lm):
    """Dense damped Cholesky solve of the pose system: (P, 6) updates,
    zero when the factorization fails or the result is not finite."""
    H = H4.reshape(P + 1, P + 1, 6, 6)[:P, :P]
    H = H.permute(0, 2, 1, 3).reshape(P * 6, P * 6)
    A = H + torch.diag(ep + lm * torch.diagonal(H))
    L, info = torch.linalg.cholesky_ex(A)
    dx = torch.cholesky_solve(vd[:P].reshape(P * 6, 1), L)
    ok = (info == 0) & torch.all(torch.isfinite(dx))
    return torch.where(ok, dx, torch.zeros_like(dx)).reshape(P, 6)


def retract_window(poses, dx, t0, t1):
    """Retract every buffer pose; only the window slots [t0, t0 + P) ∩
    [t0, t1) move."""
    buf, P = poses.shape[0], dx.shape[0]
    n = max(0, min(t1, t0 + P, buf) - t0)
    dx_full = torch.zeros((buf, 6), device=poses.device)
    dx_full[t0:t0 + n] = dx[:n]
    return se3.retr(poses, dx_full)


def depth_update(prob, depth, dx, buf):
    """Back-substitution of the problem's depth frames for the pose update
    dx (P, 6): (buf + 1, HW) disparity updates, zero off kx (row buf is a
    dump row)."""
    dev = dx.device
    K = prob["kx"].shape[0]
    HW = depth["Q"].shape[1]
    dx_pad = torch.cat([dx, torch.zeros((1, 6), device=dev)])
    Edx = torch.einsum("tah,ta->th", depth["B"], dx_pad[depth["tp"]])
    Edx = scatter.index_add_(torch.zeros((K + 1, HW), device=dev), 0,
                             depth["tk"], Edx)[:K]
    dz = depth["Q"] * (depth["w"] - Edx)
    kmask, kx = prob["kmask"], prob["kx"]
    dz = torch.where(kmask[:, None], dz, torch.zeros_like(dz))
    dz_full = torch.zeros((buf + 1, HW), device=dev)
    scatter.index_add_(dz_full, 0, torch.where(
        kmask, kx, torch.full_like(kx, buf)), dz)
    return dz_full


def ba(poses, disps, disps_sens, intrinsics, target, weight, eta,
       ii, jj, edge_mask, kx, kmask, t0, t1, *, iters=2, lm=1e-4, ep=0.1,
       motion_only=False, P=64):
    """Run `iters` damped Gauss-Newton iterations; returns (poses, disps).

    Args:
      poses (BUF, 7), disps/disps_sens (BUF, h, w), intrinsics (BUF, 4),
      eta (BUF, h, w) depth damping; target/weight (E, h, w, 2) with
      ii/jj (E,) long and edge_mask (E,) bool; kx (K,) long depth frames
      with kmask (K,) bool; t0, t1 ints: the pose window is
      [t0, min(t1, t0 + P)).
    """
    t0, t1 = int(t0), int(t1)
    buf = poses.shape[0]
    ht, wd = disps.shape[-2:]
    prob = edge_problem(ii, jj, edge_mask, target, weight, kx, kmask,
                        disps_sens, eta, t0, P)
    for _ in range(iters):
        H4, vd, depth = pose_system(prob, poses, disps, intrinsics,
                                    motion_only)
        dx = solve_poses(H4, vd, P, ep, lm)
        poses = retract_window(poses, dx, t0, t1)
        if not motion_only:
            dz = depth_update(prob, depth, dx, buf)
            disps = torch.clamp(disps + dz[:buf].reshape(buf, ht, wd),
                                min=0.001)
    return poses, disps
