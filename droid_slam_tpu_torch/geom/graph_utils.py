"""Training-graph construction from ground-truth covisibility.

Temporal neighbour edges within radius r plus the closest remaining pairs
(by ground-truth flow distance) until `num` edges, threshold 24 px.
Returns flat (ii, jj) numpy edge arrays.
"""

import numpy as np
import torch

from ..lie import se3
from . import projective


def temporal_graph(N, r=2):
    """All ordered pairs with 1 <= |i-j| <= r."""
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    keep = (ii != jj) & (np.abs(ii - jj) <= r)
    return ii[keep], jj[keep]


def compute_distance_matrix_flow(poses_c2w, disps, intrinsics, chunk=2048,
                                 max_flow=100.0):
    """All-pairs mean induced-flow magnitude, on the CPU.

    Args:
      poses_c2w: (N, 7) dataset (camera-to-world) poses; inverted here.
      disps: (N, h, w) downsampled inverse depths.
      intrinsics: (N, 4) at the disps resolution.
    Returns (N, N) float32 numpy matrix (inf where < 70% pixels valid).
    """
    poses = se3.inv(torch.as_tensor(np.asarray(poses_c2w),
                                    dtype=torch.float32))[None]
    disps_t = torch.as_tensor(np.asarray(disps), dtype=torch.float32)[None]
    intr_t = torch.as_tensor(np.asarray(intrinsics),
                             dtype=torch.float32)[None]

    N = disps_t.shape[1]
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)

    matrix = np.zeros((N, N), np.float32)
    for s in range(0, len(ii), chunk):
        iis = torch.from_numpy(ii[s:s + chunk])
        jjs = torch.from_numpy(jj[s:s + chunk])
        flow1, val1 = projective.induced_flow(poses, disps_t, intr_t, iis,
                                              jjs)
        flow2, val2 = projective.induced_flow(poses, disps_t, intr_t, jjs,
                                              iis)

        flow = torch.stack([flow1, flow2], dim=2)
        val = torch.stack([val1, val2], dim=2)
        mag = torch.linalg.norm(flow, dim=-1).clamp(max=max_flow)
        mag = mag.reshape(mag.shape[1], -1)
        valf = val.reshape(val.shape[1], -1)

        vmean = valf.mean(-1)
        m = (mag * valf).mean(-1) / vmean.clamp(min=1e-8)
        m = torch.where(vmean < 0.7, torch.full_like(m, float("inf")), m)
        matrix[ii[s:s + chunk], jj[s:s + chunk]] = m.numpy()

    return matrix


def build_frame_graph(poses, disps, intrinsics, num=16, thresh=24.0, r=2):
    """Covisibility graph from the ground-truth flow-distance matrix.

    Args:
      poses: (B, N, 7) dataset (c2w) poses — batch element 0 is used.
      disps: (B, N, H, W) full-res inverse depths.
      intrinsics: (B, N, 4) full-res.
    Returns (ii, jj) with temporal r-neighbours plus closest pairs under
    `thresh` until `num` edges.
    """
    poses = np.asarray(poses)[0]
    disps = np.asarray(disps)[0][:, 3::8, 3::8]
    intrinsics = np.asarray(intrinsics)[0] / 8.0
    N = poses.shape[0]

    d = compute_distance_matrix_flow(poses, disps, intrinsics)

    count = 0
    ii_list, jj_list = [], []
    for i in range(N):
        d[i, i] = np.inf
        for j in range(i - r, i + r + 1):
            if 0 <= j < N and i != j:
                ii_list.append(i)
                jj_list.append(j)
                d[i, j] = np.inf
                count += 1

    while count < num:
        ix = np.argmin(d)
        i, j = ix // N, ix % N
        if d[i, j] < thresh:
            ii_list.append(i)
            jj_list.append(j)
            d[i, j] = np.inf
            count += 1
        else:
            break

    return np.asarray(ii_list), np.asarray(jj_list)
