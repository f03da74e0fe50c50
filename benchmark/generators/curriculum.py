"""Training traffic: the synthetic curriculum's scene families, rendered
on the device in set-up and drawn by the trainer's generator.

Parameters (the traffic file): `scenes` and `scene_frames` to render,
the families' `motions` (translation step std, scene units) and `focals`
(share of the width), and the photometric jitter: `gain`, `bias`,
`gamma` ranges and the largest per-frame sensor noise std `noise`.  Scene
s is of family s mod 6: plain box (0, 1), box with floating occluders
(2), corridor (3), fronto-parallel plane (4), slanted plane (5), with
motion `motions[s mod 5]` and focal `focals[s mod 3]`.
"""

import numpy as np
import torch

from benchmark.generators.scenes import (box_walls, generators,
                                         plane_normal, quat_from_rotvec,
                                         reflected_walk,
                                         render_box, render_plane, textures)


def _scene(s, rng, gen, p, H, W, device):
    T = p["scene_frames"]
    motion = p["motions"][s % len(p["motions"])]
    f = p["focals"][s % len(p["focals"])] * W
    intr = np.array([f, f, W / 2, H / 2], np.float32)
    fam = s % 6
    if fam <= 3:
        if fam <= 1:
            box = (2.0 + (s % 5) * 0.4, 1.5 + (s % 3) * 0.3, 5.0 + (s % 4))
        elif fam == 2:
            box = (2.2 + (s % 4) * 0.4, 1.6 + (s % 2) * 0.3, 5.0 + (s % 3))
        else:
            box = (1.0 + (s % 2) * 0.3, 1.1, 8.0 + 2 * (s % 3))
        bx, by, bz = box
        obstacles = [(rng.uniform(1.2, 0.8 * bz), rng.uniform(0.25, 0.75),
                      rng.uniform(0.2, 0.6), rng.uniform(-0.6 * bx, 0.6 * bx),
                      rng.uniform(-0.6 * by, 0.6 * by))
                     for _ in range(1 + s % 3 if fam == 2 else 0)]
        poses = reflected_walk(rng, T, motion, 0.4,
                               [-0.5 * bx, -0.5 * by, -0.5],
                               [0.5 * bx, 0.5 * by, 0.4 * bz], 0.35)
        texs = textures(5 + len(obstacles), gen, device)
        images, depths = render_box(torch.as_tensor(poses, device=device),
                                    intr, H, W, texs,
                                    box_walls(box, obstacles))
    else:
        tilt = 0.0 if fam == 4 else 0.3 + 0.2 * (s % 2)
        normal = plane_normal(rng, tilt)
        steps = motion * rng.standard_normal((T, 6))
        steps[:, 2] *= 0.3
        steps[:, 3:] *= 0.3
        steps[0] = 0.0
        xi = np.cumsum(steps, axis=0)
        poses = np.concatenate([xi[:, :3], quat_from_rotvec(xi[:, 3:])],
                               -1).astype(np.float32)
        images, depths = render_plane(torch.as_tensor(poses, device=device),
                                      intr, H, W, textures(1, gen, device)[0],
                                      normal, 2.0)
    return dict(images=images, depths=depths, poses=poses, intrinsics=intr)


class Scenes:
    """The rendered scenes and the trainer's dataset interface."""

    def __init__(self, p, n_frames, H, W, seed, device):
        rng, self.gen = generators(seed, device)
        self.p = p
        self.N = n_frames
        self.device = device
        scenes = [_scene(s, rng, self.gen, p, H, W, device)
                  for s in range(p["scenes"])]
        self.images = torch.stack([s["images"] for s in scenes])
        self.disps = torch.stack([1.0 / s["depths"] for s in scenes])
        self.poses = np.stack([s["poses"] for s in scenes])
        self.intrinsics = np.stack([s["intrinsics"] for s in scenes])

    def __len__(self):
        return self.images.shape[0]

    def sample_batches(self, batch_size, rng):
        """Endless numpy batches dict(images (B, N, H, W, 3) f32, poses
        (B, N, 7) c2w, disps (B, N, H, W), intrinsics (B, N, 4)) drawn with
        `rng`, the photometric jitter applied on the device."""
        N, p = self.N, self.p
        T = self.images.shape[1]
        while True:
            items = []
            for _ in range(batch_size):
                s = int(rng.integers(len(self)))
                s0 = int(rng.integers(T - N + 1))
                gain = rng.uniform(*p["gain"])
                bias = rng.uniform(*p["bias"])
                gamma = rng.uniform(*p["gamma"])
                sigma = rng.uniform(0, p["noise"])
                img = self.images[s, s0:s0 + N].float() / 255.0
                img = 255.0 * img.clamp(0, 1) ** gamma * gain + bias
                img = img + sigma * torch.randn(img.shape, generator=self.gen,
                                                device=self.device)
                items.append(dict(
                    images=img.clamp(0, 255).cpu().numpy(),
                    poses=self.poses[s, s0:s0 + N],
                    disps=self.disps[s, s0:s0 + N].cpu().numpy(),
                    intrinsics=np.tile(self.intrinsics[s], (N, 1))))
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}


def make(params, H, W, seed, device, n_frames):
    return Scenes(params, n_frames, H, W, seed, device)
