"""Plain reference of the stereo tracker's stages that the stereo cells
check: the encoders over a rectified rig, the motion gate, and the two
stages of an update round (the update operator over the active edges,
then the dense bundle adjustment).

A frame is a rig of two images, left and right.  The feature encoder
runs on both cameras and the context encoder on the left one; the motion
gate compares left cameras only.  An edge (ii, jj) with ii != jj
correlates frame ii's left camera with frame jj's left camera; a rig edge
ii == jj correlates frame ii's left camera with its own right camera, and
the geometry moves its pixels by the rig's fixed baseline (projective.py,
STEREO_TX) in place of a relative pose.  The bundle adjustment is the
monocular one (dba.py), whose rig edges carry depth terms only, with the
baseline fixing the scale.

Every network stage runs in float32 with TF32 off (the matrix products
and convolutions of the float32 reference read full float32 operands);
the bundle adjustment runs in the dtype it is given (float64 for the
check).  Departures from the port: none in the mathematics; as in
tracking.py, every correlation is formed in float32 on the fly and read
by the plain bilinear gather, where the port rounds volumes to bfloat16
and reads them with its CUDA kernel."""

import functools

import numpy as np
import torch

from . import precision, projective, tracking
from .corr import edge_taps
from .droidnet import normalize_images

LEFT, RIGHT = 0, 1

# the round's dense BA and the reprojection the check compares are the
# monocular ones: dba.py gives a rig edge ii == jj depth terms only
dense_ba = tracking.dense_ba
reprojection = tracking.reprojection


def _float32(fn):
    """`fn` with TF32 off and no autograd."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with precision.tf32(False), torch.no_grad():
            return fn(*args, **kwargs)
    return wrapped


@_float32
def encode(net, images, batch=8):
    """uint8 (N, 2, H, W, 3) rigs -> fmaps (N, 2, h, w, 128) of both
    cameras, and nets (tanh) and inps (relu) (N, h, w, 128) of the left
    camera, all f32."""
    fm, nt, ip = [], [], []
    for lo in range(0, images.shape[0], batch):
        rig = images[lo:lo + batch]
        n = rig.shape[0]
        x = normalize_images(rig.reshape((2 * n,) + rig.shape[2:]))
        f = net.fnet(x).float()
        fm.append(f.reshape((n, 2) + f.shape[1:]))
        c, i = net.context(x.reshape((n, 2) + x.shape[1:])[:, LEFT])
        nt.append(c.float())
        ip.append(i.float())
    return torch.cat(fm), torch.cat(nt), torch.cat(ip)


@_float32
def gate_flow(net, frame, keyframe):
    """The motion gate's flow update (1, h, w, 2) of rig `frame` against
    rig `keyframe` (uint8 (2, H, W, 3) each), over their left cameras:
    the keyframe's features correlated with the frame's at the identity
    grid, one update step from the keyframe's context."""
    f, n, i = encode(net, torch.stack([keyframe, frame]))
    h, w = f.shape[2:4]
    coords0 = projective.coords_grid(h, w, device=f.device)
    taps = edge_taps(f[0:1, LEFT], f[1:2, LEFT], coords0[None])
    _, delta, _ = net.update(n[0:1], i[0:1], taps)
    return delta.float()


def target_features(f, ii, jj):
    """(E, h, w, C) target features of edges (ii, jj) from rig features
    `f` (N, 2, h, w, C) indexed by frame: frame jj's left camera, and
    its right camera on a rig edge ii == jj."""
    return f[jj, (ii == jj).long() * RIGHT]


@_float32
def update_operator(net, pre, images):
    """The update operator over the active edges of the state `pre` (a
    dict of the program's state before a round, see
    benchmark/runners/track.py), with the rigs' features from `images`
    (uint8 (T, 2, H, W, 3), indexed by the keyframes' timestamps).
    Returns the targets and weights of every edge slot (active ones
    updated) and the damping of every frame (the active edges' sources
    updated)."""
    dev = pre["poses"].device
    ii, jj = pre["ii"], pre["jj"]
    act = np.nonzero(pre["active"])[0]
    poses, disps, intr = pre["poses"], pre["disps"], pre["intrinsics"]
    h, w = disps.shape[1:]
    target, weight = pre["target"].clone(), pre["weight"].clone()
    damping = pre["damping"].clone()

    ii_a = torch.as_tensor(ii[act], device=dev)
    jj_a = torch.as_tensor(jj[act], device=dev)
    slots = np.unique(np.concatenate([ii[act], jj[act]]))
    stamps = pre["tstamp"].cpu().numpy()[slots].round().astype(np.int64)
    f, _, inp = encode(net, images[torch.as_tensor(stamps)].to(dev))
    row = torch.full((poses.shape[0],), -1, dtype=torch.long, device=dev)
    row[torch.as_tensor(slots, device=dev)] = torch.arange(len(slots),
                                                           device=dev)
    coords1, _ = projective.projective_transform(
        poses[None], disps[None], intr[None], ii_a, jj_a)
    coords1 = coords1[0]
    coords0 = projective.coords_grid(h, w, device=dev)
    motn = torch.clamp(torch.cat([coords1 - coords0,
                                  target[act] - coords1], dim=-1),
                       -64.0, 64.0)
    ri, rj = row[ii_a], row[jj_a]
    corr = edge_taps(f[ri, LEFT], target_features(f, ri, rj), coords1)
    frames, ix = torch.unique(ii_a, return_inverse=True)
    _, delta, wgt, eta = net.update(pre["net"], inp[ri], corr, motn,
                                    ix=ix, nseg=len(frames))
    a = torch.as_tensor(act, device=dev)
    target[a] = coords1 + delta
    weight[a] = wgt
    damping[frames] = eta
    return target, weight, damping
