"""Global bundle-adjustment backend.

Gauge-normalize (mono without sensor depth: stereo edges and depth
priors fix the scale), build a fresh proximity factor graph over all
keyframes with on-the-fly correlation, and run `update_lowmem` sweeps of
the update operator + dense global BA (convex-upsampling the keyframe
disparities under `upsample`).
"""

import numpy as np
import torch

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
    def __init__(self, net, video, cfg):
        self.net = net
        self.video = video
        self.cfg = cfg

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
        graph.add_proximity_factors(
            rad=cfg.backend_radius, nms=cfg.backend_nms,
            thresh=cfg.backend_thresh, beta=cfg.beta)
        graph.update_lowmem(steps=steps)
