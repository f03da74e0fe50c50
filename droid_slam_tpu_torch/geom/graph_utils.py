"""Training-graph construction from ground-truth covisibility.

Temporal neighbour edges within radius r plus the closest remaining pairs
(by ground-truth flow distance) until `num` edges, threshold 24 px.
Returns flat (ii, jj) numpy edge arrays.
"""

import numpy as np

from ..data.rgbd_utils import compute_distance_matrix_flow


def temporal_graph(N, r=2):
    """All ordered pairs with 1 <= |i-j| <= r."""
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    keep = (ii != jj) & (np.abs(ii - jj) <= r)
    return ii[keep], jj[keep]


def build_frame_graph(poses, disps, intrinsics, num=16, thresh=24.0, r=2,
                      device="cpu"):
    """Covisibility graph from the ground-truth flow-distance matrix.

    Args:
      poses: (B, N, 7) dataset (c2w) poses — batch element 0 is used.
      disps: (B, N, H, W) full-res inverse depths.
      intrinsics: (B, N, 4) full-res.
      device: where the flow-distance matrix is computed.
    Returns (ii, jj) with temporal r-neighbours plus closest pairs under
    `thresh` until `num` edges.
    """
    poses = np.asarray(poses)[0]
    disps = np.asarray(disps)[0][:, 3::8, 3::8]
    intrinsics = np.asarray(intrinsics)[0] / 8.0
    N = poses.shape[0]

    d = compute_distance_matrix_flow(poses, disps, intrinsics,
                                     device=device)

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
