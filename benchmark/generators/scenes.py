"""Textured synthetic scenes rendered on the device: a camera inside a
textured box (optionally with floating occluders) or in front of a
textured, optionally slanted plane.  Images are exact ray casts with
bilinear, wrap-around texture lookups; depths are the camera z-depths of
the hits.  Poses are camera-to-world [t, q] with q = (x, y, z, w)."""

import math

import numpy as np
import torch
from torch.nn import functional as F

TEX = 256                       # texture side, texels
OCTAVES = ((8, 80.0), (32, 50.0), (128, 25.0))


def textures(n, gen, device):
    """n smooth RGB textures (n, TEX, TEX, 3) in [0, 255] from noise
    octaves, bilinearly upsampled."""
    tex = torch.zeros((n, 3, TEX, TEX), device=device)
    for size, amp in OCTAVES:
        noise = torch.rand((n, 3, size, size), generator=gen, device=device)
        tex += amp * F.interpolate(noise, size=(TEX, TEX), mode="bilinear",
                                   align_corners=False)
    lo = tex.amin(dim=(1, 2, 3), keepdim=True)
    hi = tex.amax(dim=(1, 2, 3), keepdim=True)
    return (255.0 * (tex - lo) / (hi - lo + 1e-6)).permute(0, 2, 3, 1)


def quat_from_rotvec(phi):
    """(N, 3) rotation vectors -> (N, 4) unit quaternions (x, y, z, w)."""
    theta = np.linalg.norm(phi, axis=-1, keepdims=True)
    half = 0.5 * theta
    k = np.where(theta > 1e-12, np.sin(half) / np.maximum(theta, 1e-12), 0.5)
    return np.concatenate([k * phi, np.cos(half)], axis=-1)


def rot_from_quat(q):
    """(N, 4) quaternions (x, y, z, w) -> (N, 3, 3) rotation matrices."""
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
        2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
        2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def reflect(x, lo, hi):
    """Fold x into [lo, hi] by reflection at the bounds (a triangle wave):
    a walk folded so keeps the length of every step."""
    span = hi - lo
    y = np.mod(x - lo, 2 * span)
    return lo + np.where(y > span, 2 * span - y, y)


def reflected_walk(rng, n, step_std, rot_ratio, lo, hi, rot_bound):
    """Camera-to-world poses (n, 7) of a random walk with Gaussian steps
    (translation std `step_std`, rotation `rot_ratio` of it), reflected
    at the translation bounds `lo`/`hi` and at ±`rot_bound` radians."""
    steps = step_std * rng.standard_normal((n, 6))
    steps[:, 3:] *= rot_ratio
    steps[0] = 0.0
    xi = np.cumsum(steps, axis=0)
    t = reflect(xi[:, :3], np.asarray(lo), np.asarray(hi))
    phi = reflect(xi[:, 3:], -rot_bound, rot_bound)
    return np.concatenate([t, quat_from_rotvec(phi)], axis=-1).astype(
        np.float32)


def _sample_wrap(tex, u, v):
    """Bilinear lookup of tex (TEX, TEX, 3) at texel coordinates u (x),
    v (y) of any shape, wrapping around the borders."""
    x0, y0 = torch.floor(u), torch.floor(v)
    fx, fy = (u - x0)[..., None], (v - y0)[..., None]
    xa, ya = x0.long() % TEX, y0.long() % TEX
    xb, yb = (xa + 1) % TEX, (ya + 1) % TEX
    top = tex[ya, xa] * (1 - fx) + tex[ya, xb] * fx
    bot = tex[yb, xa] * (1 - fx) + tex[yb, xb] * fx
    return top * (1 - fy) + bot * fy


def camera_rays(poses, intr, H, W):
    """World ray directions (N, H, W, 3) with camera z-component 1, and
    origins (N, 3), of camera-to-world poses (N, 7)."""
    dev = poses.device
    fx, fy, cx, cy = intr
    ys, xs = torch.meshgrid(torch.arange(H, device=dev, dtype=torch.float32),
                            torch.arange(W, device=dev, dtype=torch.float32),
                            indexing="ij")
    d = torch.stack([(xs - cx) / fx, (ys - cy) / fy, torch.ones_like(xs)],
                    dim=-1)
    R = rot_from_quat(poses[:, 3:])
    return torch.einsum("nab,hwb->nhwa", R, d), poses[:, :3]


def box_walls(box, obstacles=()):
    """Planes of a box x ∈ ±bx, y ∈ ±by, z ∈ [-1, bz] (the -z wall left
    open behind the camera) and of floating occluders at depth oz with
    half sizes hx, hy around (ox, oy): (axis, offset, texture, bounds of
    the other two axes)."""
    bx, by, bz = box
    lim = {0: bx, 1: by, 2: bz}

    def bounds(axis):
        return tuple(((-1.0 if a == 2 else -lim[a]) - 1e-3, lim[a] + 1e-3)
                     for a in range(3) if a != axis)

    walls = [(0, bx, 0, bounds(0)), (0, -bx, 1, bounds(0)),
             (1, by, 2, bounds(1)), (1, -by, 3, bounds(1)),
             (2, bz, 4, bounds(2))]
    for k, (oz, hx, hy, ox, oy) in enumerate(obstacles):
        walls.append((2, oz, 5 + k, ((ox - hx, ox + hx), (oy - hy, oy + hy))))
    return walls


@torch.no_grad()
def render_box(poses, intr, H, W, texs, walls, batch=32):
    """uint8 images (N, H, W, 3) and z-depths (N, H, W) of the walls."""
    images, depths = [], []
    w2t = TEX / 3.0
    for lo in range(0, poses.shape[0], batch):
        rd, o = camera_rays(poses[lo:lo + batch], intr, H, W)
        o = o[:, None, None, :]
        best = torch.full(rd.shape[:3], 1e6, device=rd.device)
        img = torch.zeros(rd.shape, device=rd.device)
        for axis, off, ti, ((a0, a1), (b0, b1)) in walls:
            den = rd[..., axis]
            den = torch.where(den.abs() < 1e-6, torch.full_like(den, 1e-6),
                              den)
            t = (off - o[..., axis]) / den
            pw = o + t[..., None] * rd
            oth = [a for a in range(3) if a != axis]
            ok = ((t > 0.1) & (pw[..., oth[0]] >= a0) & (pw[..., oth[0]] <= a1)
                  & (pw[..., oth[1]] >= b0) & (pw[..., oth[1]] <= b1)
                  & (t < best))
            col = _sample_wrap(texs[ti], pw[..., oth[0]] * w2t + TEX / 2,
                               pw[..., oth[1]] * w2t + TEX / 2)
            img = torch.where(ok[..., None], col, img)
            best = torch.where(ok, t, best)
        images.append(img.clamp(0, 255).to(torch.uint8))
        depths.append(best.clamp(max=100.0))
    return torch.cat(images), torch.cat(depths)


@torch.no_grad()
def render_plane(poses, intr, H, W, tex, normal, plane_z, batch=32):
    """uint8 images and z-depths of a textured plane through (0, 0,
    plane_z) with unit `normal` (3,) facing the camera."""
    dev = poses.device
    n = torch.as_tensor(normal, dtype=torch.float32, device=dev)
    e1 = torch.linalg.cross(n, torch.tensor([0.0, 1.0, 0.0], device=dev))
    e1 = e1 / e1.norm()
    e2 = torch.linalg.cross(n, e1)
    p0 = torch.tensor([0.0, 0.0, plane_z], device=dev)
    w2t = TEX / 4.0
    images, depths = [], []
    for lo in range(0, poses.shape[0], batch):
        rd, o = camera_rays(poses[lo:lo + batch], intr, H, W)
        den = rd @ n
        den = torch.where(den.abs() < 1e-6, torch.full_like(den, 1e-6), den)
        t = (((p0 - o) @ n)[:, None, None] / den).clamp(0.05, 100.0)
        rel = o[:, None, None, :] + t[..., None] * rd - p0
        img = _sample_wrap(tex, rel @ e1 * w2t + TEX / 2,
                           rel @ e2 * w2t + TEX / 2)
        images.append(img.clamp(0, 255).to(torch.uint8))
        depths.append(t)
    return torch.cat(images), torch.cat(depths)


def plane_normal(rng, tilt):
    """A unit normal facing the camera (-z), tilted by `tilt` radians
    about a random in-plane axis."""
    nz = np.array([0.0, 0.0, -1.0])
    if tilt == 0.0:
        return nz
    phi = rng.uniform(0, 2 * math.pi)
    axis = np.array([math.cos(phi), math.sin(phi), 0.0])
    n = (nz * math.cos(tilt) + np.cross(axis, nz) * math.sin(tilt)
         + axis * np.dot(axis, nz) * (1 - math.cos(tilt)))
    return n / np.linalg.norm(n)


def generators(seed, device):
    """A numpy generator and a torch generator on `device`, both from
    `seed` (any non-negative integer)."""
    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(rng.integers(2 ** 62)))
    return rng, gen
