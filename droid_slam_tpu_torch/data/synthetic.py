"""Synthetic textured scenes with exact ground truth (numpy + torch).

`render_box_scene`: a camera random-walks inside a textured box looking
toward +z; `render_stereo_box_scene` renders it from a stereo rig.
`render_plane_scene`: a camera moves in front of a textured, optionally
slanted plane.  Depth maps and poses are analytic (ray/plane
intersections).  The same scene generators as the JAX package's
`data/synthetic`, with the image resampling written out in numpy:
bilinear upsampling for the noise octaves and bilinear texture lookup
with wrap-around coordinates (quantized to 1/32 pixel, as OpenCV's remap
does).  `SyntheticCurriculum` mixes both families into the dataset-free
training source.  `write_tartanair_scene` writes a plane scene in
TartanAir's on-disk layout.
"""

import os
import os.path as osp

import numpy as np
import torch
from torch.nn import functional as F

from ..geom.projective import STEREO_TX
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
                     box=(2.5, 1.8, 6.0), focal=0.9, n_obstacles=0,
                     poses_c2w=None):
    """Render a camera moving inside a textured box.

    The box spans x ∈ [−bx, bx], y ∈ [−by, by], z ∈ [−1, bz].  The camera
    random-walks from the seed unless `poses_c2w` (N, 7) gives its poses;
    the walk is drawn either way, so two calls with one seed render one
    scene.  Returns dict(images (N,H,W,3) uint8 RGB, poses_c2w (N,7),
    depths (N,H,W) f32, intrinsics (N,4)).
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
    if poses_c2w is not None:
        poses_c2w = np.asarray(poses_c2w, np.float32)
        n_frames = poses_c2w.shape[0]
    else:
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


def render_stereo_box_scene(n_frames=12, H=96, W=128, seed=0, **kw):
    """`render_box_scene` seen by a rectified stereo rig: the right camera
    has the left one's orientation and sits -STEREO_TX (0.1) along its x
    axis, the fixed baseline of the rig edges (geom/projective.py).
    Returns dict(images (N,2,H,W,3) uint8 [left, right], and the left
    camera's poses_c2w (N,7), depths (N,H,W) and intrinsics (N,4)).
    """
    left = render_box_scene(n_frames, H, W, seed=seed, **kw)
    poses = left["poses_c2w"]
    offset = so3.act(torch.from_numpy(poses[:, 3:7]),
                     torch.tensor([-STEREO_TX, 0.0, 0.0]).expand(
                         len(poses), 3)).numpy()
    poses_r = poses.copy()
    poses_r[:, :3] += offset
    right = render_box_scene(n_frames, H, W, seed=seed, poses_c2w=poses_r,
                             **kw)
    return dict(left, images=np.stack([left["images"], right["images"]],
                                      axis=1))


def render_plane_scene(n_frames=12, H=96, W=128, plane_z=2.0, seed=0,
                       motion_scale=0.04, focal=0.9, tilt=0.0):
    """Render a camera trajectory viewing a textured plane.

    The plane passes through (0, 0, plane_z); `tilt` (radians) rotates its
    normal away from -z about a random in-plane axis, giving slanted
    geometry with real depth gradients.  `focal` sets fx = fy = focal·W.
    Returns the same dict layout as `render_box_scene`.
    """
    rng = np.random.default_rng(seed)
    tex = _texture(rng)
    tex_size = tex.shape[0]
    fx = fy = focal * W
    cx, cy = W / 2, H / 2
    intr = np.array([fx, fy, cx, cy], np.float32)

    # plane frame: unit normal (towards the camera) + in-plane basis
    if tilt != 0.0:
        phi = rng.uniform(0, 2 * np.pi)
        axis = np.array([np.cos(phi), np.sin(phi), 0.0])
        nz = np.array([0.0, 0.0, -1.0])
        normal = (nz * np.cos(tilt) + np.cross(axis, nz) * np.sin(tilt)
                  + axis * np.dot(axis, nz) * (1 - np.cos(tilt)))
    else:
        normal = np.array([0.0, 0.0, -1.0])
    normal = normal / np.linalg.norm(normal)
    e1 = np.cross(normal, [0.0, 1.0, 0.0])
    e1 /= np.linalg.norm(e1)
    e2 = np.cross(normal, e1)
    p0 = np.array([0.0, 0.0, plane_z])

    # smooth random walk (c2w): mostly lateral translation, small rotation
    steps = motion_scale * rng.standard_normal((n_frames, 6))
    steps[:, 2] *= 0.3
    steps[:, 3:] *= 0.3
    steps[0] = 0
    xi = np.cumsum(steps, axis=0)
    poses_c2w = se3.exp(torch.from_numpy(xi.astype(np.float32))).numpy()

    w2t = tex_size / 4.0     # 1 world unit = tex_size/4 px, centered
    ys, xs = np.mgrid[0:H, 0:W].astype(np.float32)
    dirs = np.stack([(xs - cx) / fx, (ys - cy) / fy, np.ones_like(xs)],
                    axis=-1)
    dirs_t = torch.from_numpy(dirs.reshape(-1, 3))

    images, depths = [], []
    for n in range(n_frames):
        g = poses_c2w[n]
        Rd = so3.act(torch.from_numpy(g[3:7]), dirs_t).numpy().reshape(
            H, W, 3)
        o = g[:3]
        denom = Rd @ normal
        t = ((p0 - o) @ normal) / np.where(np.abs(denom) < 1e-6, 1e-6, denom)
        t = np.clip(t, 0.05, 100.0)
        pw = o + t[..., None] * Rd
        # dirs has camera-z component 1, so the camera z-depth of the
        # intersection is exactly the ray parameter t
        rel = pw - p0
        u = (rel @ e1) * w2t + tex_size / 2
        v = (rel @ e2) * w2t + tex_size / 2
        img = _sample_wrap(tex, u.astype(np.float32), v.astype(np.float32))
        images.append(np.clip(img, 0, 255).astype(np.uint8))
        depths.append(t.astype(np.float32))

    return dict(
        images=np.stack(images), poses_c2w=poses_c2w.astype(np.float32),
        depths=np.stack(depths), intrinsics=np.tile(intr, (n_frames, 1)),
    )


# inverse of the reader's NED permutation [1, 2, 0, 4, 5, 3, 6]
# (data/tartan.py)
_NED_INV = [2, 0, 1, 5, 3, 4, 6]


def write_tartanair_scene(root, scene="synth/synth/Easy/P001", n_frames=12,
                          H=96, W=128, seed=0, depth_scale=5.0, **render_kw):
    """Write a rendered plane scene in TartanAir's on-disk layout under
    root/scene: image_left/*.png (through `data/image_io.write_png`),
    depth_left/*.npy and pose_left.txt (c2w, NED order), depths and
    translations times depth_scale.  `render_kw` goes to
    `render_plane_scene` (focal=0.5 at W=640 is TartanAir's fx = fy =
    320).  Returns the rendered scene."""
    from .image_io import write_png

    data = render_plane_scene(n_frames, H, W, seed=seed, **render_kw)
    sdir = osp.join(root, scene)
    os.makedirs(osp.join(sdir, "image_left"), exist_ok=True)
    os.makedirs(osp.join(sdir, "depth_left"), exist_ok=True)

    for n in range(n_frames):
        write_png(osp.join(sdir, "image_left", f"{n:06d}_left.png"),
                  data["images"][n])
        np.save(osp.join(sdir, "depth_left", f"{n:06d}_left_depth.npy"),
                data["depths"][n] * depth_scale)

    poses = data["poses_c2w"].copy()
    poses[:, :3] *= depth_scale
    np.savetxt(osp.join(sdir, "pose_left.txt"), poses[:, _NED_INV],
               delimiter=" ")
    return data


class SyntheticCurriculum:
    """Dataset-free training source: rendered box interiors (plain, with
    floating occluders, corridors) and textured planes (fronto-parallel
    and slanted) across a range of motion scales and focal lengths.

    Scene seeds start at 1000, apart from the seeds evaluation uses.
    Sequences are longer than the training window, so a scene gives many
    window starts.
    """

    def __init__(self, cfg, n_scenes=96):
        self.cfg = cfg
        H, W = cfg.image_size
        T = max(16, cfg.n_frames + 2)
        self.scenes = [self._render(s, T, H, W) for s in range(n_scenes)]

    @staticmethod
    def _render(s, T, H, W):
        seed = 1000 + s
        motion = [0.04, 0.08, 0.12, 0.16, 0.20][s % 5]
        focal = [0.75, 0.9, 1.1][s % 3]
        common = dict(seed=seed, motion_scale=motion, focal=focal)
        fam = s % 6
        if fam <= 1:            # plain box interiors
            return render_box_scene(
                T, H, W, **common,
                box=(2.0 + (s % 5) * 0.4, 1.5 + (s % 3) * 0.3, 5.0 + (s % 4)))
        if fam == 2:            # box + floating occluders
            return render_box_scene(
                T, H, W, **common, n_obstacles=1 + (s % 3),
                box=(2.2 + (s % 4) * 0.4, 1.6 + (s % 2) * 0.3, 5.0 + (s % 3)))
        if fam == 3:            # corridor: narrow, deep box
            return render_box_scene(
                T, H, W, **common,
                box=(1.0 + (s % 2) * 0.3, 1.1, 8.0 + 2 * (s % 3)))
        if fam == 4:            # fronto-parallel plane
            return render_plane_scene(T, H, W, **common)
        return render_plane_scene(T, H, W, **common,   # slanted plane
                                  tilt=0.3 + 0.2 * (s % 2))

    def sample_batches(self, batch_size, rng):
        """Endless batches dict(images (B,N,H,W,3) f32, poses (B,N,7) c2w,
        disps (B,N,H,W), intrinsics (B,N,4)) drawn with `rng`."""
        N = self.cfg.n_frames
        H, W = self.cfg.image_size
        # scale diversity: a share of batches are random 8-aligned crops
        # at the next size down
        ch, cw = max(64, H - 32), max(96, W - 32)
        do_crop = (ch, cw) != (H, W)
        while True:
            crop = do_crop and rng.random() < 0.4
            if crop:
                y0 = 8 * rng.integers(0, (H - ch) // 8 + 1)
                x0 = 8 * rng.integers(0, (W - cw) // 8 + 1)
            items = []
            for _ in range(batch_size):
                sc = self.scenes[rng.integers(len(self.scenes))]
                s0 = rng.integers(sc["images"].shape[0] - N + 1)
                img = sc["images"][s0:s0 + N].astype(np.float32)
                dsp = (1.0 / sc["depths"][s0:s0 + N]).astype(np.float32)
                intr = sc["intrinsics"][s0:s0 + N].copy()
                if crop:
                    img = img[:, y0:y0 + ch, x0:x0 + cw]
                    dsp = dsp[:, y0:y0 + ch, x0:x0 + cw]
                    intr[:, 2] -= x0
                    intr[:, 3] -= y0
                # photometric jitter: per-sequence brightness, contrast
                # and gamma, per-frame sensor noise; geometry untouched
                gain = rng.uniform(0.7, 1.3)
                bias = rng.uniform(-20, 20)
                gamma = rng.uniform(0.85, 1.2)
                img = 255.0 * (np.clip(img / 255.0, 0, 1) ** gamma)
                img = img * gain + bias
                img = img + rng.normal(0, rng.uniform(0, 4),
                                       img.shape).astype(np.float32)
                img = np.clip(img, 0, 255)
                items.append(dict(images=img,
                                  poses=sc["poses_c2w"][s0:s0 + N],
                                  disps=dsp, intrinsics=intr))
            yield {k: np.stack([it[k] for it in items]) for k in items[0]}

    def __len__(self):
        return len(self.scenes)
