"""Frame-distance metric: mean reprojection flow between frame pairs.

For each pair (i, j), the β-blend of (a) the mean flow magnitude of the
full relative motion and (b) the mean flow of the translation-only
motion, each over pixels whose transformed depth exceeds MIN_DEPTH;
pairs with < 75% valid pixels get distance 1000.
"""

import torch

from ..geom import projective
from ..lie import se3

MIN_DEPTH = projective.MIN_DEPTH


def _flow_dist(disps_i, intr, tij, qij, use_rotation):
    ht, wd = disps_i.shape[-2:]
    X0 = projective.iproj(disps_i, intr)                   # (..., H, W, 4)
    if use_rotation:
        g = torch.cat([tij, qij], dim=-1)
        X1 = se3.act(g[..., None, None, :], X0)
    else:
        Xv = X0[..., :3] + X0[..., 3:4] * tij[..., None, None, :]
        X1 = torch.cat([Xv, X0[..., 3:4]], dim=-1)

    coords, _ = projective.proj(X1, intr)
    grid = projective.coords_grid(ht, wd, device=disps_i.device,
                                  dtype=disps_i.dtype)
    d = torch.linalg.norm(coords - grid, dim=-1)
    valid = (X1[..., 2] > MIN_DEPTH).to(d.dtype)
    acc = torch.sum(valid * d, dim=(-2, -1))
    cnt = torch.sum(valid, dim=(-2, -1))
    return acc, cnt, float(ht * wd)


def frame_distance(poses, disps, intrinsics, ii, jj, beta=0.3):
    """Distance for each pair (ii[k], jj[k]).

    poses (BUF, 7); disps (BUF, h, w); intrinsics (4,) shared; ii, jj (N,)
    long.  Returns (N,) float32.
    """
    gij = se3.mul(poses[jj], se3.inv(poses[ii]))
    tij, qij = gij[..., :3], gij[..., 3:7]
    di = disps[ii]
    intr = intrinsics.expand(ii.shape + (4,))

    acc_r, cnt_r, total = _flow_dist(di, intr, tij, qij, True)
    acc_t, cnt_t, _ = _flow_dist(di, intr, tij, qij, False)

    acc = beta * acc_r + (1.0 - beta) * acc_t
    valid = beta * cnt_r + (1.0 - beta) * cnt_t
    frac = valid / (total + 1e-8)
    dist = acc / torch.clamp(valid, min=1e-8)
    return torch.where(frac < 0.75, torch.full_like(dist, 1000.0), dist)


def distance_matrix(poses, disps, intrinsics, t, beta=0.3):
    """(t, t) bidirectional mean distance matrix."""
    dev = poses.device
    ii, jj = torch.meshgrid(torch.arange(t, device=dev),
                            torch.arange(t, device=dev), indexing="ij")
    ii, jj = ii.reshape(-1), jj.reshape(-1)
    d1 = frame_distance(poses, disps, intrinsics, ii, jj, beta)
    d2 = frame_distance(poses, disps, intrinsics, jj, ii, beta)
    return (0.5 * (d1 + d2)).reshape(t, t)
