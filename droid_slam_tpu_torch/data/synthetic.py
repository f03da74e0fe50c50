"""Synthetic textured-box scenes with exact ground truth (numpy + torch).

A camera random-walks inside a textured box looking toward +z; depth maps
and poses are analytic (nearest ray/plane intersection).  The same scene
generator as the JAX package's `data/synthetic.render_box_scene`, with
the image resampling written out in numpy: bilinear upsampling for the
noise octaves and bilinear texture lookup with wrap-around coordinates
(quantized to 1/32 pixel, as OpenCV's remap does).
"""

import numpy as np
import torch
from torch.nn import functional as F

from ..lie import se3, so3

_SUBPIX = 32          # texture-coordinate quantization (1/32 pixel)


def _resize_bilinear(img, size):
    """(h, w, C) float32 -> (size, size, C), half-pixel centers, edge
    clamped."""
    x = torch.from_numpy(np.ascontiguousarray(img.transpose(2, 0, 1)))[None]
    y = F.interpolate(x, size=(size, size), mode="bilinear",
                      align_corners=False)
    return y[0].numpy().transpose(1, 2, 0)


def _texture(rng, size=512):
    """Smooth random RGB texture via upsampled noise octaves."""
    tex = np.zeros((size, size, 3), np.float32)
    for octave, amp in [(8, 80), (32, 50), (128, 25)]:
        noise = rng.random((octave, octave, 3)).astype(np.float32)
        tex += amp * _resize_bilinear(noise, size)
    tex = 255 * (tex - tex.min()) / (np.ptp(tex) + 1e-6)
    return tex.astype(np.float32)


def _sample_wrap(tex, u, v):
    """Bilinear lookup of tex (S, S, 3) at float maps u (x), v (y) with
    wrap-around borders."""
    S = tex.shape[0]
    qu = np.round(u.astype(np.float64) * _SUBPIX).astype(np.int64)
    qv = np.round(v.astype(np.float64) * _SUBPIX).astype(np.int64)
    x0, y0 = qu // _SUBPIX, qv // _SUBPIX
    fx = ((qu % _SUBPIX) / _SUBPIX).astype(np.float32)[..., None]
    fy = ((qv % _SUBPIX) / _SUBPIX).astype(np.float32)[..., None]
    xa, xb = x0 % S, (x0 + 1) % S
    ya, yb = y0 % S, (y0 + 1) % S
    top = tex[ya, xa] * (1 - fx) + tex[ya, xb] * fx
    bot = tex[yb, xa] * (1 - fx) + tex[yb, xb] * fx
    return top * (1 - fy) + bot * fy


def render_box_scene(n_frames=12, H=96, W=128, seed=0, motion_scale=0.08,
                     box=(2.5, 1.8, 6.0), focal=0.9, n_obstacles=0):
    """Render a camera moving inside a textured box.

    The box spans x ∈ [−bx, bx], y ∈ [−by, by], z ∈ [−1, bz].  Returns
    dict(images (N,H,W,3) uint8 RGB, poses_c2w (N,7), depths (N,H,W) f32,
    intrinsics (N,4)).
    """
    rng = np.random.default_rng(seed)
    bx, by, bz = box
    fx = fy = focal * W
    cx, cy = W / 2, H / 2
    intr = np.array([fx, fy, cx, cy], np.float32)

    texs = [_texture(rng, 256) for _ in range(5 + n_obstacles)]
    tex_size = 256
    w2t = tex_size / 3.0

    # bounded random walk
    steps = motion_scale * rng.standard_normal((n_frames, 6))
    steps[:, 3:] *= 0.4
    steps[0] = 0
    xi = np.cumsum(steps, axis=0)
    xi[:, 0] = np.clip(xi[:, 0], -0.5 * bx, 0.5 * bx)
    xi[:, 1] = np.clip(xi[:, 1], -0.5 * by, 0.5 * by)
    xi[:, 2] = np.clip(xi[:, 2], -0.5, 0.4 * bz)
    xi[:, 3:] = np.clip(xi[:, 3:], -0.35, 0.35)
    poses_c2w = se3.exp(torch.from_numpy(xi.astype(np.float32))).numpy()

    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    dirs = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)],
                    axis=-1)

    lim = {0: bx, 1: by, 2: bz}

    def _wall_bounds(axis):
        oth = [a for a in range(3) if a != axis]
        return tuple(((-1.0 if a == 2 else -lim[a]) - 1e-3, lim[a] + 1e-3)
                     for a in oth)

    walls = [(0, bx, 0, _wall_bounds(0)), (0, -bx, 1, _wall_bounds(0)),
             (1, by, 2, _wall_bounds(1)), (1, -by, 3, _wall_bounds(1)),
             (2, bz, 4, _wall_bounds(2))]
    for k in range(n_obstacles):
        oz = rng.uniform(1.2, 0.8 * bz)
        hx = rng.uniform(0.25, 0.75)
        hy = rng.uniform(0.2, 0.6)
        ox = rng.uniform(-0.6 * bx, 0.6 * bx)
        oy = rng.uniform(-0.6 * by, 0.6 * by)
        walls.append((2, oz, 5 + k,
                      ((ox - hx, ox + hx), (oy - hy, oy + hy))))

    dirs_t = torch.from_numpy(dirs.reshape(-1, 3))
    images, depths = [], []
    for n in range(n_frames):
        g = poses_c2w[n]
        Rd = so3.act(torch.from_numpy(g[3:7]), dirs_t).numpy().reshape(
            H, W, 3)
        o = g[:3]

        best_t = np.full((H, W), 1e6, np.float32)
        img = np.zeros((H, W, 3), np.float32)
        for axis, off, ti, bounds in walls:
            denom = Rd[..., axis]
            t = (off - o[axis]) / np.where(np.abs(denom) < 1e-6, 1e-6, denom)
            pw = o + t[..., None] * Rd
            oth = [a for a in range(3) if a != axis]
            ok = ((t > 0.1)
                  & (pw[..., oth[0]] >= bounds[0][0])
                  & (pw[..., oth[0]] <= bounds[0][1])
                  & (pw[..., oth[1]] >= bounds[1][0])
                  & (pw[..., oth[1]] <= bounds[1][1])
                  & (t < best_t))
            u = pw[..., oth[0]] * w2t + tex_size / 2
            v = pw[..., oth[1]] * w2t + tex_size / 2
            wall_img = _sample_wrap(texs[ti], u.astype(np.float32),
                                    v.astype(np.float32))
            img = np.where(ok[..., None], wall_img, img)
            best_t = np.where(ok, t, best_t)

        images.append(np.clip(img, 0, 255).astype(np.uint8))
        depths.append(np.minimum(best_t, 100.0).astype(np.float32))

    return dict(
        images=np.stack(images), poses_c2w=poses_c2w.astype(np.float32),
        depths=np.stack(depths), intrinsics=np.tile(intr, (n_frames, 1)),
    )
