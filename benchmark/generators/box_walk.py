"""Tracking traffic: one camera walking inside a textured box.

Parameters (the traffic file): `frames` to render, the Gaussian step std
of the translation per frame (`step_std`, scene units) and of the
rotation (`rot_ratio` of it, radians), the box half sizes `box`, the
focal length as a share of the width (`focal`), the walk's translation
bounds `lo`/`hi` and rotation bound `rot_bound`, and `setup_frames`, the
frames tracked in set-up.  The walk is reflected at its bounds, so its
speed holds over any length.  With `walk_seed` the walk is drawn from it
and `--seed` changes only the textures: every seed then asks for the
same motion, and so for nearly the same keyframe steps.
"""

import numpy as np
import torch

from benchmark.generators.scenes import box_walls, generators, reflected_walk, render_box, textures


def make(params, H, W, seed, device):
    """dict(images (T, H, W, 3) uint8 on `device`, intrinsics (4,) numpy
    f32, poses (T, 7) c2w numpy)."""
    rng, gen = generators(seed, device)
    if "walk_seed" in params:
        rng = np.random.default_rng(params["walk_seed"])
    poses = reflected_walk(rng, params["frames"], params["step_std"],
                           params["rot_ratio"], params["lo"], params["hi"],
                           params["rot_bound"])
    f = params["focal"] * W
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    texs = textures(5, gen, device)
    images, _ = render_box(torch.as_tensor(poses, device=device), intr, H, W,
                           texs, box_walls(params["box"]))
    return dict(images=images, intrinsics=intr, poses=poses)
