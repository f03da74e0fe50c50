"""Keyframe map state: fixed-capacity buffers on the device + host counter.

Pre-allocated per-keyframe buffers (timestamps, poses, inverse depths,
sensor depths, convex-upsampled inverse depths, intrinsics,
correlation/context/GRU features) and the geometric operations on them
(reproject, frame distance, BA, gauge normalization).  Buffers are
updated in place.
"""

import dataclasses

import numpy as np
import torch

from ..geom import projective
from ..ops import dba, distance


@dataclasses.dataclass
class VideoState:
    tstamp: torch.Tensor       # (BUF,) f32
    poses: torch.Tensor        # (BUF, 7) f32, w2c
    disps: torch.Tensor        # (BUF, h, w) f32, init 1
    disps_sens: torch.Tensor   # (BUF, h, w) f32
    disps_up: torch.Tensor     # (BUF, H, W) f32; (1, H, W) unless upsample
    intrinsics: torch.Tensor   # (BUF, 4) f32 at 1/8 resolution
    fmaps: torch.Tensor        # (BUF, rig, h, w, 128) bf16, camera 0 left
    nets: torch.Tensor         # (BUF, h, w, 128) f16
    inps: torch.Tensor         # (BUF, h, w, 128) f16
    damping: torch.Tensor      # (BUF, h, w) f32
    colors: torch.Tensor       # (BUF, h, w, 3) uint8 RGB at [3::8, 3::8]

    # buffers copied by the keyframe shift (`DepthVideo.copy_slot`):
    # everything but damping, and disps_up, which the shift copies only
    # under upsample
    SHIFTED = ("tstamp", "poses", "disps", "disps_sens",
               "intrinsics", "fmaps", "nets", "inps", "colors")


def init_state(buffer, image_size, device, stereo=False, upsample=False):
    H, W = image_size
    h, w = H // 8, W // 8
    rig = 2 if stereo else 1
    poses = torch.zeros((buffer, 7), device=device)
    poses[:, 6] = 1.0
    return VideoState(
        tstamp=torch.zeros((buffer,), device=device),
        poses=poses,
        disps=torch.ones((buffer, h, w), device=device),
        disps_sens=torch.zeros((buffer, h, w), device=device),
        # written only by the convex upsampling: a one-row placeholder
        # otherwise, as (BUF, H, W) f32 is large
        disps_up=torch.zeros((buffer if upsample else 1, H, W),
                             device=device),
        intrinsics=torch.zeros((buffer, 4), device=device),
        fmaps=torch.zeros((buffer, rig, h, w, 128), dtype=torch.bfloat16,
                          device=device),
        # f16 context/GRU-seed stores, as the reference's fp16 buffers;
        # readers promote.  Not bf16: these bounded activations need
        # f16's extra mantissa bits.
        nets=torch.zeros((buffer, h, w, 128), dtype=torch.float16,
                         device=device),
        inps=torch.zeros((buffer, h, w, 128), dtype=torch.float16,
                         device=device),
        damping=torch.full((buffer, h, w), 1e-6, device=device),
        # the left image at the disparity pixels' centres: the colours of
        # the exported point cloud (runtime/visualization.py)
        colors=torch.zeros((buffer, h, w, 3), dtype=torch.uint8,
                           device=device),
    )


def pool_pyramid(x, levels=4):
    """Average-pooled pyramid of (N, h, w, C) features: means in float32,
    each level rounded to x's dtype.  The one pooling of the correlation
    pyramid (frontend, boot graph, backend and filler)."""
    out = [x]
    for _ in range(levels - 1):
        N, h, w, C = x.shape
        h2, w2 = h // 2 * 2, w // 2 * 2
        x = (x[:, :h2, :w2].float()
             .reshape(N, h2 // 2, 2, w2 // 2, 2, C).mean((2, 4))
             .to(x.dtype))
        out.append(x)
    return out


def keyframe_colors(image):
    """(rig, H, W, 3) uint8 tensor -> (h, w, 3): the left camera at the
    centres of the 8x8 cells of the disparity map."""
    return image[0, 3::8, 3::8]


def disp_from_depth(depth, shape):
    """Sensor depth (H, W) -> inverse depth sampled at pixel centers
    [3::8, 3::8] (zeros where the depth is missing)."""
    if depth is None:
        return np.zeros(shape, np.float32)
    d = np.asarray(depth)[3::8, 3::8]
    return np.where(d > 0, 1.0 / np.maximum(d, 1e-8), 0.0).astype(
        np.float32)


class DepthVideo:
    """Host wrapper: keyframe counter + the VideoState buffers."""

    def __init__(self, config, device):
        self.cfg = config
        self.device = torch.device(device)
        self.counter = 0
        self.state = init_state(config.buffer, config.image_size,
                                self.device, config.stereo, config.upsample)
        self.ht, self.wd = config.image_size
        self.fht, self.fwd = self.ht // 8, self.wd // 8

    def append(self, tstamp, pose, disp, depth, intrinsics,
               fmap, net, inp, image=None):
        """Add a keyframe at slot `counter`.

        pose / disp None keep the slot's current values (the frontend
        extrapolates the next keyframe into them); a scalar disp fills
        the slot.  depth: optional full-resolution metric depth; image:
        optional (rig, H, W, 3) uint8 tensor, whose left camera gives the
        slot's colours.
        """
        if self.counter >= self.cfg.buffer:
            raise RuntimeError(
                f"keyframe buffer full ({self.cfg.buffer} slots): raise "
                f"SLAMConfig.buffer or keyframe_thresh")
        st, c = self.state, self.counter
        st.tstamp[c] = float(tstamp)
        if pose is not None:
            st.poses[c] = torch.as_tensor(pose, dtype=torch.float32)
        if disp is not None:
            st.disps[c] = torch.as_tensor(disp, dtype=torch.float32)
        st.disps_sens[c] = torch.as_tensor(
            disp_from_depth(depth, (self.fht, self.fwd)))
        st.intrinsics[c] = torch.as_tensor(intrinsics, dtype=torch.float32)
        st.fmaps[c] = fmap.to(st.fmaps.dtype)   # (1 | rig, h, w, 128)
        st.nets[c] = net.to(st.nets.dtype)
        st.inps[c] = inp.to(st.inps.dtype)
        if image is not None:
            st.colors[c] = keyframe_colors(image)
        self.counter += 1

    def copy_slot(self, dst, src):
        """Keyframe slot src -> dst in every buffer the culling shift
        moves (both frontends remove a keyframe with it); disps_up only
        under `upsample` (a one-row placeholder otherwise)."""
        st = self.state
        for name in st.SHIFTED + (("disps_up",) if self.cfg.upsample
                                  else ()):
            arr = getattr(st, name)
            arr[dst] = arr[src]

    def normalize(self):
        """Fix the monocular scale gauge: mean disparity of the keyframes
        -> 1."""
        st, n = self.state, self.counter
        s = st.disps[:n].sum() / (n * st.disps.shape[1] * st.disps.shape[2])
        st.disps[:n] /= s
        st.poses[:n, :3] *= s

    def reproject(self, ii, jj):
        st = self.state
        coords, valid = projective.projective_transform(
            st.poses[None], st.disps[None], st.intrinsics[None], ii, jj)
        return coords[0], valid[0]

    # pairs per frame_distance pass: each pair materializes (h, w, 2)
    # flow fields
    DISTANCE_CHUNK = 16384

    def distance(self, ii, jj, beta=0.3, bidirectional=True):
        """Frame distances for the pairs (ii, jj), as a device tensor."""
        st = self.state
        ii = torch.as_tensor(np.asarray(ii, np.int64).reshape(-1),
                             device=self.device)
        jj = torch.as_tensor(np.asarray(jj, np.int64).reshape(-1),
                             device=self.device)
        intr = st.intrinsics[0]
        outs = []
        for lo in range(0, len(ii), self.DISTANCE_CHUNK):
            a = ii[lo:lo + self.DISTANCE_CHUNK]
            b = jj[lo:lo + self.DISTANCE_CHUNK]
            d = distance.frame_distance(st.poses, st.disps, intr, a, b, beta)
            if bidirectional:
                d2 = distance.frame_distance(st.poses, st.disps, intr, b, a,
                                             beta)
                d = 0.5 * (d + d2)
            outs.append(d)
        return torch.cat(outs) if outs else torch.zeros(0,
                                                        device=self.device)

    def ba(self, target, weight, eta, ii, jj, edge_mask, t0, t1, itrs=2,
           lm=1e-4, ep=0.1, motion_only=False, pose_cap=None,
           depth_cap=None):
        """Dense BA over host edge lists (ii, jj, edge_mask numpy)."""
        cfg = self.cfg
        P = pose_cap or cfg.frontend_pose_cap
        K = depth_cap or cfg.frontend_depth_cap
        kx, kmask = dba.build_schur_tables(ii, edge_mask, t0, t1, K)
        dev = self.device
        st = self.state
        poses, disps = dba.ba(
            st.poses, st.disps, st.disps_sens, st.intrinsics, target,
            weight, eta,
            torch.as_tensor(np.asarray(ii, np.int64), device=dev),
            torch.as_tensor(np.asarray(jj, np.int64), device=dev),
            torch.as_tensor(np.asarray(edge_mask, bool), device=dev),
            torch.as_tensor(kx, device=dev), torch.as_tensor(kmask,
                                                              device=dev),
            t0, t1, iters=itrs, lm=lm, ep=ep, motion_only=motion_only, P=P)
        st.poses.copy_(poses)
        st.disps.copy_(disps)
