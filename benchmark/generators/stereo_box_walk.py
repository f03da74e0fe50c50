"""Stereo tracking traffic: box_walk.py's camera walk, seen by a rectified
rig.  The right camera has the left one's orientation and sits
`baseline` scene units along the left camera's x axis (the port's rig,
-STEREO_TX = 0.1: geom/projective.py), as
`droid_slam_tpu_torch.data.synthetic.render_stereo_box_scene` places it.

Parameters (the traffic file): box_walk.py's, and `baseline`.
"""

import numpy as np
import torch

from benchmark.generators.scenes import (box_walls, generators,
                                         reflected_walk, render_box,
                                         rot_from_quat, textures)


def right_poses(poses, baseline):
    """Camera-to-world poses (n, 7) of the right cameras of a rig whose
    left cameras are at `poses`."""
    R = rot_from_quat(torch.as_tensor(poses[:, 3:]))
    right = poses.copy()
    right[:, :3] += baseline * R[:, :, 0].numpy()
    return right


def make(params, H, W, seed, device):
    """dict(images (T, 2, H, W, 3) uint8 [left, right] on `device`,
    intrinsics (4,) numpy f32, poses (T, 7) c2w of the left camera)."""
    rng, gen = generators(seed, device)
    poses = reflected_walk(rng, params["frames"], params["step_std"],
                           params["rot_ratio"], params["lo"], params["hi"],
                           params["rot_bound"])
    f = params["focal"] * W
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    texs = textures(5, gen, device)
    walls = box_walls(params["box"])
    cams = [render_box(torch.as_tensor(p, device=device), intr, H, W, texs,
                       walls)[0]
            for p in (poses, right_poses(poses, params["baseline"]))]
    return dict(images=torch.stack(cams, dim=1), intrinsics=intr,
                poses=poses)
