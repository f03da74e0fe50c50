"""Dense bundle adjustment of the fused keyframe step at fixed shapes.

The same damped Gauss-Newton as `ops/dba.ba` (same per-edge
linearization, depth elimination by Schur complement, dense Cholesky
pose solve, float32), written so that no shape depends on the data and
the host never waits: every edge slot of the graph state is linearized,
and slots outside the BA mask are selected to zero; the pose window
[t0, t1) and the depth frames kx are device tensors; index plumbing is
0/1 selector products, as in the JAX package, where `ops/dba` gathers
edges with `torch.nonzero` and scatters over a pair list.  So a round's
whole BA can be one CUDA graph (`GraphedRound`), replayed at every
keyframe round in place of a few thousand launches.

The Schur complement scatters each depth frame's coupling terms into a
dense G of shape (K, 6P, HW) (frame k, pose row p·6 + a, pixel): the
self term Σ_e Eii at pose ii − t0 and one Eij term per edge at pose
jj − t0.  Then S = Σ_k G_k Q_k G_kᵀ and the back-substitution reads
G_kᵀ dx; by bilinearity these equal `ops/dba`'s sums over term pairs,
in another summation order.  Memory grows as K·P·HW, so this path
serves the frontend's small fixed window; the backend, the boot and
`parallel/dba.py` keep `ops/dba`.

The round's edge data travels as one int64 host array (`pack`): ii, jj,
the BA mask (E slots each), kx, kmask (K each), t0 and t1.
"""

import numpy as np
import torch

from ..geom import projective
from ..lie import se3
from ..utils import graphs
from ..utils.timers import span
from .dba import ALPHA, W_SCALE

HV_CHUNK = 128        # residual rows per product of the Gauss-Newton blocks


def pack(ii, jj, mask, kx, kmask, t0, t1):
    """One round's indices as one int64 array; slots outside `mask` read
    frame 0 (any frame in the buffer would do: their terms are zeroed)."""
    mask = np.asarray(mask, bool)
    return np.concatenate([
        np.where(mask, ii, 0), np.where(mask, jj, 0), mask, kx, kmask,
        [t0, t1]]).astype(np.int64)


def unpack(idx, E, K):
    """(ii, jj, mask, kx, kmask, t0, t1) of a packed index tensor; t0 and
    t1 are 0-d tensors."""
    ii, jj, m = idx[:E], idx[E:2 * E], idx[2 * E:3 * E] != 0
    kx, km = idx[3 * E:3 * E + K], idx[3 * E + K:3 * E + 2 * K] != 0
    return ii, jj, m, kx, km, idx[3 * E + 2 * K], idx[3 * E + 2 * K + 1]


def _linearize(poses, disps, intrinsics, target, weight, ii, jj, m):
    """`ops/dba._linearize`'s per-edge blocks for every slot, zero outside
    the mask `m`, on `geom/projective`'s transform and Jacobians (the
    formulas the JAX package uses): Hv (E, 13, 13) holds Hblk as
    [:12, :12] and v as [12, :12]; EE (E, 12, HW) holds Eii as [:, :6]
    and Eij as [:, 6:]; Cii, wi (E, HW).  A masked slot's residual and
    weight are selected to zero (it may hold NaN or inf; its indices read
    frame 0)."""
    E = ii.shape[0]
    HW = disps.shape[-2] * disps.shape[-1]
    coords, valid, (Ji, Jj, Jz) = projective.projective_transform(
        poses[None], disps[None], intrinsics[None], ii, jj, jacobian=True)
    keep = m.view(E, 1, 1, 1)
    r = torch.where(keep, target - coords[0], 0.0).reshape(E, HW, 2)
    w = torch.where(keep, W_SCALE * (valid[0] * weight), 0.0).reshape(
        E, HW, 2)
    w_pose = w * (ii != jj).view(E, 1, 1).to(w.dtype)
    Jz = Jz[0].reshape(E, HW, 2)

    # rows [Ji | Jj | r], one a residual; Hv = Σ_rows w·rowᵀrow, summed in
    # chunks of HV_CHUNK rows (a batch of many small products)
    J = torch.cat([Ji[0].reshape(E, HW, 2, 6), Jj[0].reshape(E, HW, 2, 6),
                   r[..., None]], dim=-1).reshape(E, HW * 2, 13)
    n = HV_CHUNK if (HW * 2) % HV_CHUNK == 0 else HW * 2
    wJ = (w_pose.reshape(E, HW * 2, 1) * J).view(-1, n, 13)
    Hv = torch.bmm(wJ.transpose(1, 2), J.view(-1, n, 13)).view(
        E, -1, 13, 13).sum(1)

    a = w_pose * Jz
    J4 = J.view(E, HW, 2, 13)[..., :12]
    EE = (a[..., 0:1] * J4[:, :, 0] + a[..., 1:2] * J4[:, :, 1]).transpose(
        1, 2).contiguous()
    Cii = torch.sum(w * Jz * Jz, dim=-1)
    wi = torch.sum(w * r * Jz, dim=-1)
    return Hv, EE, Cii, wi


def ba(poses, disps, disps_sens, intrinsics, target, weight, eta, idx, *,
       K, P, iters=2, lm=1e-4, ep=0.1):
    """`iters` damped Gauss-Newton iterations over the masked edge slots;
    returns (poses, disps).  Semantics of `ops/dba.ba` (motion_only
    aside) with the pose window [t0, min(t1, t0 + P)).

    Args:
      poses (BUF, 7), disps/disps_sens/eta (BUF, h, w), intrinsics
      (BUF, 4); target/weight (E, h, w, 2) for every edge slot; idx the
      (3E + 2K + 2,) int64 tensor of `pack`.
    """
    dev, f32 = poses.device, torch.float32
    E = target.shape[0]
    buf, ht, wd = disps.shape
    HW = ht * wd
    ii, jj, m, kx, km, t0, t1 = unpack(idx, E, K)

    # selectors, fixed across the iterations: edge → pose slot (none
    # outside the window), edge → depth frame, buffer row → depth frame,
    # buffer row → pose slot
    slot = torch.arange(P, device=dev)
    rows = torch.arange(buf, device=dev)
    Pi = ((ii - t0)[:, None] == slot) & m[:, None]          # (E, P)
    Pj = ((jj - t0)[:, None] == slot) & m[:, None]
    M = (ii[:, None] == kx) & km & m[:, None]               # (E, K)
    # [e·2 + r, k·P + p]: edge e's term r (0: Eii at pose ii, 1: Eij at
    # pose jj) into the coupling of its depth frame k
    U = torch.stack([Pi, Pj], dim=1)                        # (E, 2, P)
    SG = (M[:, None, :, None] & U[:, :, None, :]).reshape(
        E * 2, K * P).to(f32)
    U = U.to(f32)
    W = (U[:, :, None, :, None] * torch.eye(6, device=dev)[:, None, :]
         ).reshape(E * 12, 6 * P)                           # [e·12+r·6+a, p·6+b]
    Mf = M.to(f32)
    B2K = ((rows[:, None] == kx) & km).to(f32)              # (BUF, K)
    R = (((rows - t0)[:, None] == slot)
         & (rows < t1)[:, None]).to(f32)                    # (BUF, P)

    dsk = disps_sens.reshape(buf, HW)[kx]
    eta_k = eta.reshape(buf, HW)[kx]
    m_sens = (dsk > 0).to(f32)

    for _ in range(iters):
        Hv, EE, Cii, wi = _linearize(poses, disps, intrinsics, target,
                                     weight, ii, jj, m)

        # pose system
        T = torch.bmm(Hv[:, :12, :12], W.view(E, 12, 6 * P))
        H = W.T @ T.reshape(E * 12, 6 * P)
        vd = W.T @ Hv[:, 12, :12].reshape(E * 12)

        # depth frames: diagonal, right-hand side, coupling G
        dk = disps.reshape(buf, HW)[kx]
        C = Mf.T @ Cii + m_sens * ALPHA + (1.0 - m_sens) * eta_k
        w = Mf.T @ wi - m_sens * ALPHA * (dk - dsk)
        Q = torch.where(km[:, None], 1.0 / C, 0.0)
        G = (SG.T @ EE.view(E * 2, 6 * HW)).view(K, 6 * P, HW)

        # Schur complement and the damped pose solve
        A = H - torch.bmm(G * Q[:, None, :], G.transpose(1, 2)).sum(0)
        rhs = vd - torch.bmm(G, (Q * w)[:, :, None]).sum(0)[:, 0]
        A = A + torch.diag(ep + lm * torch.diagonal(A))
        L, info = torch.linalg.cholesky_ex(A)
        y = torch.linalg.solve_triangular(L, rhs[:, None], upper=False)
        dx = torch.linalg.solve_triangular(L.mT, y, upper=True)
        ok = (info == 0) & torch.isfinite(dx).all()
        dx = torch.where(ok, dx, 0.0).reshape(P, 6)
        poses = se3.retr(poses, R @ dx)

        # depth back-substitution, scattered to the buffer rows
        Edx = torch.matmul(dx.reshape(1, 6 * P), G)[:, 0]    # (K, HW)
        dz = torch.where(km[:, None], Q * (w - Edx), 0.0)
        disps = torch.clamp(disps + (B2K @ dz).view(buf, ht, wd),
                            min=0.001)
    return poses, disps


class GraphedRound:
    """`fn(*tensors, idx)` at shapes fixed per instance: on the CPU called
    as it is; on CUDA captured once into a CUDA graph that reads static
    copies of `tensors`, then replayed (spans `ba.capture`, `ba.replay`).
    On CUDA `idx` is a device tensor of fixed storage that the caller
    fills before each call (the keyframe step's upload of a round's
    indices): the graph reads it in place, so every call passes that same
    tensor.  The outputs are the graph's own buffers, valid until the
    next call."""

    def __init__(self, fn):
        self.fn = fn
        self.graph = None

    def capture(self, tensors, idx):
        """Capture `fn` over static copies of the tensors and over `idx`
        itself."""
        with span("ba.capture"), torch.no_grad():
            self.static = [t.clone() for t in tensors]
            self.idx = idx
            self.graph, self.out = graphs.capture(
                lambda: self.fn(*self.static, self.idx))

    def __call__(self, tensors, idx):
        if not tensors[0].is_cuda:
            return self.fn(*tensors, idx)
        if self.graph is None:
            self.capture(tensors, idx)
        if (idx.data_ptr(), idx.shape) != (self.idx.data_ptr(),
                                          self.idx.shape):
            raise ValueError("the BA graph reads the index tensor it was "
                             "captured with; pass that tensor")
        for s, t in zip(self.static, tensors):
            s.copy_(t)
        with span("ba.replay"):
            self.graph.replay()
        return self.out
