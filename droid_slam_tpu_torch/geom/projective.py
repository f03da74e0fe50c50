"""Projective camera geometry with analytic Jacobians.

Conventions (identical to the JAX package and the reference):
  * inverse-depth ("disparity") parameterization; homogeneous points are
    ``[X, Y, 1, d]`` in the source camera;
  * poses are world-to-camera SE3; the relative motion for an edge (i, j)
    is ``G_ij = G_j ∘ G_i⁻¹``; stereo (ii == jj) edges use the fixed
    baseline ``t = [-0.1, 0, 0]``;
  * pixels with transformed or source depth < MIN_DEPTH (= 0.2) are
    invalid;
  * the pose-i Jacobian is ``Ji = -adjT(G_ij, Jj)``.
"""

import torch

from ..lie import se3
from ..utils.timers import sync_site

MIN_DEPTH = 0.2
STEREO_TX = -0.1


def _matmul_small(A, B):
    """Batched (..., m, k) @ (..., k, n) for tiny trailing dims, as a
    broadcast multiply + sum (the JAX package's summation order)."""
    return torch.sum(A[..., :, :, None] * B[..., None, :, :], dim=-2)


def coords_grid(ht, wd, device=None, dtype=torch.float32):
    """Pixel-center coordinate grid, shape (ht, wd, 2) ordered [x, y]."""
    y, x = torch.meshgrid(
        torch.arange(ht, device=device, dtype=dtype),
        torch.arange(wd, device=device, dtype=dtype),
        indexing="ij",
    )
    return torch.stack([x, y], dim=-1)


def _split_intr(intrinsics):
    return intrinsics[..., None, None, :].unbind(-1)


def iproj(disps, intrinsics):
    """Pinhole back-projection: disps (..., H, W), intrinsics (..., 4)
    [fx, fy, cx, cy] -> (..., H, W, 4) points [X, Y, 1, d]."""
    ht, wd = disps.shape[-2:]
    fx, fy, cx, cy = _split_intr(intrinsics)
    grid = coords_grid(ht, wd, device=disps.device, dtype=disps.dtype)
    x, y = grid[..., 0], grid[..., 1]
    X = (x - cx) / fx
    Y = (y - cy) / fy
    X, Y, d = torch.broadcast_tensors(X, Y, disps)
    return torch.stack([X, Y, torch.ones_like(d), d], dim=-1)


def proj(Xs, intrinsics, jacobian=False, return_depth=False):
    """Pinhole projection of (..., H, W, 4) points; returns coords
    (..., H, W, 2[+1]) and, if jacobian, the (..., H, W, 2, 4) Jacobian."""
    fx, fy, cx, cy = _split_intr(intrinsics)
    X, Y, Z, D = Xs.unbind(-1)

    Z = torch.where(Z < 0.5 * MIN_DEPTH, torch.ones_like(Z), Z)
    d = 1.0 / Z

    x = fx * (X * d) + cx
    y = fy * (Y * d) + cy
    if return_depth:
        coords = torch.stack(torch.broadcast_tensors(x, y, D * d), dim=-1)
    else:
        coords = torch.stack(torch.broadcast_tensors(x, y), dim=-1)

    if not jacobian:
        return coords, None

    o = torch.zeros_like(d)
    Jp = torch.stack(
        torch.broadcast_tensors(
            fx * d, o, -fx * X * d * d, o,
            o, fy * d, -fy * Y * d * d, o,
        ),
        dim=-1,
    )
    return coords, Jp.reshape(Jp.shape[:-1] + (2, 4))


def actp(Gij, X0, jacobian=False):
    """SE3 action of Gij (..., 7) on point grids X0 (..., H, W, 4), with
    the 4×6 generator Jacobian (translation-first twists)."""
    X1 = se3.act(Gij[..., None, None, :], X0)

    if not jacobian:
        return X1, None

    X, Y, Z, d = X1.unbind(-1)
    o = torch.zeros_like(d)
    Ja = torch.stack(
        [
            d, o, o, o, Z, -Y,
            o, d, o, -Z, o, X,
            o, o, d, Y, -X, o,
            o, o, o, o, o, o,
        ],
        dim=-1,
    ).reshape(d.shape + (4, 6))
    return X1, Ja


def _edge_transform(poses, ii, jj, stereo_tx=STEREO_TX):
    """Per-edge G_ij = G_jj ∘ G_ii⁻¹, fixed baseline on ii == jj edges."""
    Gi = poses[..., ii, :]
    Gj = poses[..., jj, :]
    Gij = se3.mul(Gj, se3.inv(Gi))
    with sync_site("h2d.const"):
        stereo = poses.new_tensor([stereo_tx, 0.0, 0.0, 0.0, 0.0, 0.0, 1.0])
    rig = (ii == jj)[..., None]
    return torch.where(rig, stereo, Gij)


def projective_transform(poses, depths, intrinsics, ii, jj, jacobian=False,
                         return_depth=False):
    """Map pixel grids of frames ii into frames jj.

    Args:
      poses: (B, P, 7) world-to-camera SE3.
      depths: (B, P, H, W) inverse depths.
      intrinsics: (B, P, 4).
      ii, jj: (E,) long edge endpoints.

    Returns:
      coords (B, E, H, W, 2[+1]), valid (B, E, H, W, 1) and, if jacobian,
      (Ji, Jj, Jz) of shapes (B,E,H,W,2,6), (B,E,H,W,2,6), (B,E,H,W,2,1).
    """
    X0 = iproj(depths[:, ii], intrinsics[:, ii])
    Gij = _edge_transform(poses, ii, jj)
    X1, Ja = actp(Gij, X0, jacobian=jacobian)
    x1, Jp = proj(X1, intrinsics[:, jj], jacobian=jacobian,
                  return_depth=return_depth)

    valid = (X1[..., 2] > MIN_DEPTH) & (X0[..., 2] > MIN_DEPTH)
    valid = valid[..., None].to(depths.dtype)

    if not jacobian:
        return x1, valid

    Jj = _matmul_small(Jp, Ja)                     # (B,E,H,W,2,6)
    Ji = -se3.adjT(Gij[..., None, None, None, :], Jj)
    # depth Jacobian: G acting on [0,0,0,1] is [t, 1]; project through Jp
    e4 = torch.cat([torch.zeros_like(X0[..., :3]),
                    torch.ones_like(X0[..., 3:4])], dim=-1)
    Jz_pt = se3.act(Gij[..., None, None, :], e4)
    Jz = _matmul_small(Jp, Jz_pt[..., None])       # (B,E,H,W,2,1)
    return x1, valid, (Ji, Jj, Jz)


def induced_flow(poses, disps, intrinsics, ii, jj):
    """Optical flow induced by camera motion: (B, E, H, W, 2) and the
    validity mask."""
    ht, wd = disps.shape[-2:]
    coords0 = coords_grid(ht, wd, device=disps.device, dtype=disps.dtype)
    coords1, valid = projective_transform(poses, disps, intrinsics, ii, jj)
    return coords1[..., :2] - coords0, valid
