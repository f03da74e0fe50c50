"""Distributed global bundle adjustment over a list of devices.

The factor graph's edges are partitioned by source frame (numpy, on the
host), so that every depth frame's Schur elimination is local to one
shard.  Each shard linearizes its own edges and eliminates its own depth
frames on its device (`ops/dba.pose_system`).  The pose systems H − S,
v − vs are summed over the shards in shard order on the first device
(`reduce_pose_systems`), solved once there, and the pose update goes to
every shard; each shard back-substitutes the depths of its frames, and
the disjoint depth updates are merged on the first device.

What crosses between devices: once per call, each shard's rows of the
targets and weights, and the whole sensor-disparity and damping buffers
(BUF × h × w each); every iteration, the poses (BUF × 7) and the whole
disparity buffer to each shard, its pose system ((P+1)² 6×6 blocks) and
its depth update, a (BUF+1) × h·w buffer that is zero off its frames,
back to the first device.  A shard reads only its own frames'
disparities, so cutting what is sent to those rows is left to do.

A shard's Schur complement is built per depth frame from the poses that
frame couples to (ops/dba.py), so there is no separate "compact" variant
as in the JAX package, and no per-frame degree cap or edge table: edges
are gathered by index.  The shard capacities (edges, depth frames) only
pad: padded edges are masked and padded frames have no unknowns.
"""

import numpy as np
import torch

from ..ops import dba as dba_ops


def _partition_frames(ii, edge_mask, t0, t1, n_shards):
    """Contiguous partition of the depth frames (the window [t0, t1) and
    every masked source frame) into n_shards ranges balanced by edge
    count: SLAM graphs are temporally local, so contiguous ranges keep
    each shard's pose coupling narrow.

    Returns (shard_frames: list of frame lists, frame_edges: dict frame ->
    edge indices).
    """
    ii = np.asarray(ii)
    edge_mask = np.asarray(edge_mask, bool)
    frames = np.unique(np.concatenate([np.arange(t0, t1), ii[edge_mask]]))
    frame_edges = {int(f): np.nonzero((ii == f) & edge_mask)[0]
                   for f in frames}
    loads = np.array([len(frame_edges[int(f)]) for f in frames], np.int64)
    cum = np.cumsum(loads)
    total = max(int(cum[-1]), 1) if len(cum) else 1
    shard_frames = [[] for _ in range(n_shards)]
    for k, f in enumerate(frames):
        s = min(int(max(cum[k] - 1, 0) * n_shards // total), n_shards - 1)
        shard_frames[s].append(int(f))
    return shard_frames, frame_edges


def plan_shard_caps(ii, edge_mask, t0, t1, n_shards):
    """The most edges and the most depth frames any shard of the
    partition needs; callers bucket them into the shard capacities."""
    shard_frames, frame_edges = _partition_frames(ii, edge_mask, t0, t1,
                                                  n_shards)
    need_e = max(sum(len(frame_edges[f]) for f in fr) for fr in shard_frames)
    need_k = max(len(fr) for fr in shard_frames)
    return max(need_e, 1), max(need_k, 1)


def shard_edges_by_frame(ii, jj, edge_mask, n_shards, E_shard, K_shard, t0,
                         t1):
    """Partition the masked edges so all edges of one source frame land on
    one shard (`_partition_frames`).

    Returns per-shard numpy arrays: ii, jj, rows (S, E_shard) — rows index
    the caller's edge arrays (target, weight) —, mask (S, E_shard), and
    the shard's depth frames kx with kmask (S, K_shard).
    """
    ii = np.asarray(ii)
    jj = np.asarray(jj)
    shard_frames, frame_edges = _partition_frames(ii, edge_mask, t0, t1,
                                                  n_shards)
    out_ii = np.zeros((n_shards, E_shard), np.int64)
    out_jj = np.zeros((n_shards, E_shard), np.int64)
    out_rows = np.zeros((n_shards, E_shard), np.int64)
    out_msk = np.zeros((n_shards, E_shard), bool)
    out_kx = np.zeros((n_shards, K_shard), np.int64)
    out_km = np.zeros((n_shards, K_shard), bool)
    for s, fr in enumerate(shard_frames):
        if len(fr) > K_shard:
            raise ValueError(f"shard {s} needs {len(fr)} depth frames > cap "
                             f"{K_shard}")
        e = np.concatenate([frame_edges[f] for f in fr]) if fr else \
            np.zeros(0, np.int64)
        if len(e) > E_shard:
            raise ValueError(f"shard {s} needs {len(e)} edge slots > cap "
                             f"{E_shard}")
        out_kx[s, :len(fr)] = fr
        out_km[s, :len(fr)] = True
        out_ii[s, :len(e)] = ii[e]
        out_jj[s, :len(e)] = jj[e]
        out_rows[s, :len(e)] = e
        out_msk[s, :len(e)] = True
    return out_ii, out_jj, out_rows, out_msk, out_kx, out_km


def reduce_pose_systems(systems, device):
    """Sum the shards' pose systems [(H4, vd), ...] on `device`, adding
    them in shard order (a fixed order, so a run repeats bit for bit)."""
    H4, vd = (x.to(device) for x in systems[0])
    for h, v in systems[1:]:
        H4 = H4 + h.to(device)
        vd = vd + v.to(device)
    return H4, vd


def distributed_ba(poses, disps, disps_sens, intrinsics, eta, target, weight,
                   shards, devices, t0, t1, *, iters=2, lm=1e-5, ep=1e-2,
                   P=128):
    """`iters` Gauss-Newton iterations of dense BA with the edges split
    into the shards of `shard_edges_by_frame`, shard s on devices[s].

    poses (BUF, 7), disps/disps_sens/eta (BUF, h, w), intrinsics (BUF, 4)
    and target/weight (E, h, w, 2) lie on the first device, where the
    pose system is solved; returns (poses, disps) there.
    """
    ii, jj, rows, mask, kx, kmask = shards
    if len(devices) != len(ii):
        raise ValueError(f"{len(ii)} shards for {len(devices)} devices")
    dev0 = torch.device(devices[0])
    t0, t1 = int(t0), int(t1)
    buf = poses.shape[0]
    ht, wd = disps.shape[-2:]

    probs = []
    for s, dev in enumerate(devices):
        r = torch.as_tensor(rows[s], device=target.device)
        ii_s, jj_s, mask_s, kx_s, km_s = (
            torch.as_tensor(x[s], device=dev) for x in (ii, jj, mask, kx,
                                                       kmask))
        probs.append(dba_ops.edge_problem(
            ii_s, jj_s, mask_s, target[r].to(dev), weight[r].to(dev), kx_s,
            km_s, disps_sens.to(dev), eta.to(dev), t0, P))
    intr = [intrinsics.to(dev) for dev in devices]

    for _ in range(iters):
        parts = []
        for s, dev in enumerate(devices):
            H4, vd, depth = dba_ops.pose_system(
                probs[s], poses.to(dev), disps.to(dev), intr[s])
            parts.append((H4, vd, depth))
        H4, vd = reduce_pose_systems([p[:2] for p in parts], dev0)
        dx = dba_ops.solve_poses(H4, vd, P, ep, lm)
        poses = dba_ops.retract_window(poses, dx, t0, t1)
        # each shard's depth frames; the sets are disjoint, so the sum in
        # shard order only merges them
        dz = torch.zeros((buf + 1, ht * wd), device=dev0)
        for s, dev in enumerate(devices):
            dz = dz + dba_ops.depth_update(probs[s], parts[s][2],
                                           dx.to(dev), buf).to(dev0)
        disps = torch.clamp(disps + dz[:buf].reshape(buf, ht, wd), min=0.001)
    return poses, disps
