"""Timestamp lists and their association (TUM-RGBD tools).

`parse_list` and `associate_frames` of the JAX package's
`data/rgbd_utils.py`; its flow-distance matrices serve the training
readers, which are not ported yet.
"""

import numpy as np


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
