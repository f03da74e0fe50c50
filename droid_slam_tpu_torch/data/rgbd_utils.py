"""Timestamp lists and their association (TUM-RGBD tools), and the
flow-distance matrices of the training readers.

The JAX package's `data/rgbd_utils.py`, with the induced flow of the
port's `geom/projective` computed on a torch device.
"""

import numpy as np
import torch

from ..geom import projective
from ..lie import se3
from ..utils.timers import sync_site


def parse_list(filepath, skiprows=0):
    """A space-separated text list (rgb.txt, depth.txt, groundtruth.txt)
    as an array of strings."""
    return np.loadtxt(filepath, delimiter=" ", dtype=str,
                      skiprows=skiprows)


def associate_frames(tstamp_image, tstamp_depth, tstamp_pose,
                     max_dt=0.08):
    """Associate image/depth(/pose) timestamps: for every image the
    nearest depth (and pose) stamp, kept when each is within max_dt.
    Returns (i, j) or (i, j, k) index tuples."""
    associations = []
    for i, t in enumerate(tstamp_image):
        j = np.argmin(np.abs(tstamp_depth - t))
        if tstamp_pose is None:
            if np.abs(tstamp_depth[j] - t) < max_dt:
                associations.append((i, j))
        else:
            k = np.argmin(np.abs(tstamp_pose - t))
            if (np.abs(tstamp_depth[j] - t) < max_dt) and \
               (np.abs(tstamp_pose[k] - t) < max_dt):
                associations.append((i, j, k))
    return associations


def compute_distance_matrix_flow(poses, disps, intrinsics, chunk=2048,
                                 max_flow=100.0, device="cpu"):
    """All-pairs mean induced-flow magnitude.

    Args:
      poses: (N, 7) dataset poses [t, q]; inverted here, as the reference
        does (`SE3(poses).inv()`), whatever convention they are in.
      disps: (N, h, w) downsampled inverse depths.
      intrinsics: (N, 4) at the disps resolution.
      device: the torch device the flows are computed on.
    Returns the (N, N) float32 numpy matrix (inf where under 70% of the
    pixels are valid).
    """
    def dev(x):
        with sync_site("h2d.graph"):
            return torch.as_tensor(np.asarray(x), dtype=torch.float32,
                                   device=device)

    poses_t = se3.inv(dev(poses))[None]
    disps_t = dev(disps)[None]
    intr_t = dev(intrinsics)[None]

    N = disps_t.shape[1]
    ii, jj = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    ii = ii.reshape(-1)
    jj = jj.reshape(-1)

    matrix = np.zeros((N, N), np.float32)
    for s in range(0, len(ii), chunk):
        with sync_site("h2d.graph", 2):
            iis = torch.as_tensor(ii[s:s + chunk], device=device)
            jjs = torch.as_tensor(jj[s:s + chunk], device=device)
        flow1, val1 = projective.induced_flow(poses_t, disps_t, intr_t, iis,
                                              jjs)
        flow2, val2 = projective.induced_flow(poses_t, disps_t, intr_t, jjs,
                                              iis)

        flow = torch.stack([flow1, flow2], dim=2)
        val = torch.stack([val1, val2], dim=2)
        mag = torch.linalg.norm(flow, dim=-1).clamp(max=max_flow)
        mag = mag.reshape(mag.shape[1], -1)
        valf = val.reshape(val.shape[1], -1)

        vmean = valf.mean(-1)
        m = (mag * valf).mean(-1) / vmean.clamp(min=1e-8)
        m = torch.where(vmean < 0.7, torch.full_like(m, float("inf")), m)
        with sync_site("graph.cpu"):
            matrix[ii[s:s + chunk], jj[s:s + chunk]] = m.cpu().numpy()

    return matrix


def build_frame_graph_from_files(poses, depth_files, intrinsics, depth_read,
                                 f=16, max_flow=256, device="cpu"):
    """Covisibility graph of a scene: depths subsampled by f, the f-scaled
    flow-distance matrix, pairs under max_flow kept.  Returns {i: (j,
    d[i, j])} over the frames."""

    def read_disp(fn):
        depth = depth_read(fn)[f // 2::f, f // 2::f]
        depth[depth < 0.01] = np.mean(depth)
        return 1.0 / depth

    disps = np.stack([read_disp(fn) for fn in depth_files], 0)
    d = f * compute_distance_matrix_flow(
        np.asarray(poses), disps, np.asarray(intrinsics) / f, device=device)

    graph = {}
    for i in range(d.shape[0]):
        j, = np.where(d[i] < max_flow)
        graph[i] = (j, d[i, j])
    return graph
