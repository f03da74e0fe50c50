"""Global bundle-adjustment backend.

Gauge-normalize (mono without sensor depth: stereo edges and depth
priors fix the scale), build a fresh proximity factor graph over all
keyframes with on-the-fly correlation, and run `update_lowmem` sweeps of
the update operator + dense global BA (convex-upsampling the keyframe
disparities under `upsample`).

With `SLAMConfig.distributed_backend` (or `distributed=True`) and a BA
mesh of more than one device, the sweeps' BA runs the edge-sharded
solver (parallel/dba.py): edges split by source frame across the
devices, each depth frame eliminated on its own shard, only the pose
system summed across them.
"""

import numpy as np
import torch

from ..parallel import dba as pdba
from ..parallel.launch import ba_mesh
from ..utils.mem import log_mem
from .factor_graph import FactorGraph


def _bucket(n, lo=32):
    b = lo
    while b < n:
        b *= 2
    return b


def edge_budget(video, max_factors):
    """Cap the 16·t edge policy to what fits the card's free memory (the
    per-edge state: f16 GRU hidden, f32 target/weight, the update's
    transients and the BA linearization outputs).  No cap on the CPU."""
    if video.device.type != "cuda":
        return max_factors
    free, _ = torch.cuda.mem_get_info(video.device)
    ht, wd = video.fht, video.fwd
    per_edge = ht * wd * (128 * 2 + 2 * 4 * 2 + 6 * 4 + (2 * 6 + 2) * 4)
    cap = max(int(0.8 * free // per_edge), 512)
    return min(cap, max_factors)


class Backend:
    def __init__(self, net, video, cfg, distributed=None, mesh=None):
        """distributed: use the edge-sharded BA (default
        `cfg.distributed_backend`); mesh: its devices (default
        `ba_mesh()`, every visible card)."""
        self.net = net
        self.video = video
        self.cfg = cfg
        self.distributed = (cfg.distributed_backend if distributed is None
                            else distributed)
        self.mesh = mesh

    @torch.no_grad()
    def __call__(self, steps=12):
        cfg = self.cfg
        t = self.video.counter
        if t < 2:
            return

        has_sens = bool((self.video.state.disps_sens[:t] > 0).any())
        if not cfg.stereo and not has_sens:
            self.video.normalize()

        max_factors = edge_budget(self.video, 16 * t)
        pose_cap = _bucket(t)
        graph = FactorGraph(
            self.video, self.net, max_factors=max_factors,
            edge_cap=int(np.ceil(max_factors / 128) * 128),
            inac_cap=8, pose_cap=pose_cap, depth_cap=pose_cap,
            # f16 GRU state, as the reference's fp16 autocast state
            state_dtype=torch.float16, upsample=cfg.upsample,
        )
        if self.distributed:
            devices = ba_mesh(devices=self.mesh)
            if len(devices) > 1:
                graph.ba_fn = self._distributed_hook(pose_cap, devices)

        dev = self.video.device
        log_mem("backend: graph built", dev)
        graph.add_proximity_factors(
            rad=cfg.backend_radius, nms=cfg.backend_nms,
            thresh=cfg.backend_thresh, beta=cfg.beta)
        log_mem(f"backend: proximity selected {graph.n} edges", dev)
        graph.update_lowmem(steps=steps)
        log_mem("backend: sweeps done", dev)

    def _distributed_hook(self, pose_cap, devices):
        """update_lowmem's BA through the edge-sharded solver over
        `devices`; shard capacities are bucketed as the pose window is."""
        cfg, video = self.cfg, self.video

        def hook(target, weight, eta, ii, jj, mask, t0, t1):
            em = np.asarray(mask, bool)
            if not em.any():
                return
            need_e, need_k = pdba.plan_shard_caps(ii, em, t0, t1,
                                                  len(devices))
            shards = pdba.shard_edges_by_frame(
                ii, jj, em, len(devices), _bucket(need_e, lo=16),
                _bucket(need_k, lo=8), t0, t1)
            st = video.state
            poses, disps = pdba.distributed_ba(
                st.poses, st.disps, st.disps_sens, st.intrinsics, eta,
                target, weight, shards, devices, t0, t1,
                iters=cfg.ba_iters, lm=cfg.backend_lm, ep=cfg.backend_ep,
                P=pose_cap)
            st.poses.copy_(poses)
            st.disps.copy_(disps)

        return hook
