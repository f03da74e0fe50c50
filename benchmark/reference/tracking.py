"""Plain reference of the tracker's stages that the tracking cells
check: the encoders, the motion gate, and the two stages of an update
round (the update operator over the active edges, then the dense bundle
adjustment).

The encoders and the gate work from the images alone.  The update
operator is followed from the program's state just before the round
(poses, disparities, damping, the edges with their GRU state, targets
and weights), with the features of every frame it reads recomputed here
from the images; the bundle adjustment from the same state and the
targets, weights and damping that the program's update operator gave,
in float64."""

import numpy as np
import torch

from . import dba, projective
from .corr import edge_taps
from .droidnet import normalize_images

DAMPING_EPS = 1e-7


@torch.no_grad()
def encode(net, images, batch=16):
    """uint8 (N, H, W, 3) -> fmaps, nets (tanh), inps (relu), each
    (N, h, w, 128) f32."""
    out = [], [], []
    for lo in range(0, images.shape[0], batch):
        x = normalize_images(images[lo:lo + batch])
        f = net.fnet(x)
        n, i = net.context(x)
        for o, v in zip(out, (f, n, i)):
            o.append(v.float())
    return tuple(torch.cat(o) for o in out)


@torch.no_grad()
def gate_flow(net, frame, keyframe):
    """The motion gate's flow update (1, h, w, 2) of `frame` against
    `keyframe` (uint8 (H, W, 3) each): the keyframe's features correlated
    with the frame's at the identity grid, one update step from the
    keyframe's context.  The gate passes a frame whose mean update norm
    exceeds the threshold."""
    f, n, i = encode(net, torch.stack([keyframe, frame]))
    h, w = f.shape[1:3]
    coords0 = projective.coords_grid(h, w, device=f.device)
    taps = edge_taps(f[0:1], f[1:2], coords0[None])
    _, delta, _ = net.update(n[0:1], i[0:1], taps)
    return delta.float()


def build_kx(ii, mask_ba, t0, t1b, buf, K):
    """Depth frames [t0, t1b) ∪ {ii of BA edges}, ascending, K at most."""
    member = np.zeros(buf, bool)
    member[max(t0, 0):max(min(t1b, buf), 0)] = True
    member[ii[mask_ba & (ii >= 0) & (ii < buf)]] = True
    frames = np.nonzero(member)[0]
    kx = np.zeros(K, np.int64)
    kmask = np.zeros(K, bool)
    n = min(len(frames), K)
    kx[:n] = frames[:n]
    kmask[:n] = True
    return kx, kmask


def window_caps(cfg):
    """(P, K): pose and depth-frame capacity of the keyframe step's BA."""
    survive = int(np.ceil((cfg["max_age"] + 1)
                          / max(1, cfg["frontend_iters1"])))
    kmax = cfg["frontend_window"] + 3 + survive
    P = max(32, int(np.ceil(kmax / 8) * 8))
    return P, P


@torch.no_grad()
def update_operator(net, pre, images):
    """The update operator over the active edges of the state `pre` (a
    dict of the program's state before a round, see
    benchmark/runners/track.py), with the frames' features from `images`
    (uint8 (T, H, W, 3), indexed by the keyframes' timestamps).  Returns
    the targets and weights of every edge slot (active ones updated) and
    the damping of every frame (the active edges' sources updated)."""
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
    corr = edge_taps(f[row[ii_a]], f[row[jj_a]], coords1)
    frames, ix = torch.unique(ii_a, return_inverse=True)
    _, delta, wgt, eta = net.update(pre["net"], inp[row[ii_a]], corr, motn,
                                    ix=ix, nseg=len(frames))
    a = torch.as_tensor(act, device=dev)
    target[a] = coords1 + delta
    weight[a] = wgt
    damping[frames] = eta
    return target, weight, damping


@torch.no_grad()
def dense_ba(cfg, pre, target, weight, damping, dtype=torch.float64):
    """The round's dense bundle adjustment over active ∪ recent-inactive
    edges from the poses and disparities of `pre`, with the edges'
    `target` and `weight` and the frames' `damping` after the update
    operator, computed in `dtype`.  Returns dict(poses (BUF, 7), disps
    (BUF, h, w), the pose window (t0, t1) that moves, the depth frames
    kx and the slots of the edges it solved over)."""
    dev = pre["poses"].device
    ii, jj = pre["ii"], pre["jj"]
    EA = pre["active"].shape[0]
    act = np.nonzero(pre["active"])[0]
    poses, disps = pre["poses"].to(dtype), pre["disps"].to(dtype)
    target, weight = target.to(dtype), weight.to(dtype)
    damping = damping.to(dtype)
    exist = np.concatenate([pre["active"], pre["inac"]])
    buf = poses.shape[0]
    ii_act, jj_act = ii[act], jj[act]
    t0 = max(1, int(ii_act.min()) + 1)
    t1b = int(np.maximum(ii_act, jj_act).max()) + 1
    recent = (ii >= t0 - 3) & (jj >= t0 - 3)
    mask_ba = exist & recent
    mask_ba[:EA] = pre["active"]
    P, K = window_caps(cfg)
    kx, kmask = build_kx(ii, mask_ba, t0, t1b, buf, K)
    poses_new, disps_new = dba.ba(
        poses, disps, pre["disps_sens"].to(dtype),
        pre["intrinsics"].to(dtype), target, weight,
        0.2 * damping + DAMPING_EPS, torch.as_tensor(ii, device=dev),
        torch.as_tensor(jj, device=dev), torch.as_tensor(mask_ba, device=dev),
        torch.as_tensor(kx, device=dev), torch.as_tensor(kmask, device=dev),
        t0, t1b, iters=cfg["ba_iters"], lm=cfg["frontend_lm"],
        ep=cfg["frontend_ep"], P=P)
    ok = torch.isfinite(poses_new.sum()) & torch.isfinite(disps_new.sum())
    return dict(poses=torch.where(ok, poses_new, poses),
                disps=torch.where(ok, disps_new, disps),
                window=(t0, min(t1b, t0 + P)), kx=kx[kmask],
                edges=np.nonzero(mask_ba)[0])


@torch.no_grad()
def reprojection(pre, poses, disps, edges):
    """Where the pixels of each edge's source land in its target under
    `poses` and `disps`, in float64: coords (E, h, w, 2) and their
    validity (E, h, w).  Unlike poses and disparities themselves, these
    do not move with the monocular scale gauge."""
    dev = poses.device
    ii = torch.as_tensor(pre["ii"][edges], device=dev)
    jj = torch.as_tensor(pre["jj"][edges], device=dev)
    coords, valid = projective.projective_transform(
        poses.double()[None], disps.double()[None],
        pre["intrinsics"].double()[None], ii, jj)
    return coords[0], valid[0, ..., 0] > 0
