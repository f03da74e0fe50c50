"""The host-driven frontend (`SLAMConfig(fused=False)`) and the warmup
bootstrap both frontends share.

After `warmup` keyframes, `initialize` builds a temporal-neighborhood
graph and runs 8 update rounds, adds proximity edges and runs 8 more,
then extrapolates the next pose/disparity.  The fused frontend
(runtime/fused.py) adopts that graph; this one keeps driving it, one
`_update` per new keyframe: evict edges older than `max_age` into the
inactive store, add proximity edges, seed the keyframe from sensor
depth, run `iters1` rounds, then cull the keyframe before it by flow
distance (`rm_keyframe`) or run `iters2` more rounds, and extrapolate.
"""

import torch

from ..utils.timers import GLOBAL_TIMERS as _T
from .factor_graph import FactorGraph
from .fused import extrapolate


class Frontend:
    def __init__(self, net, video, cfg):
        self.video = video
        self.cfg = cfg
        # one update chunk over the full edge capacity, so GraphAgg
        # averages over all edges of a frame
        self.graph = FactorGraph(video, net,
                                 max_factors=cfg.frontend_max_factors,
                                 update_chunk=cfg.frontend_edge_cap,
                                 upsample=cfg.upsample)
        self.t0 = 0
        self.t1 = 0
        self.is_initialized = False
        self.count = 0

    def __call__(self):
        if not self.is_initialized and self.video.counter == self.cfg.warmup:
            self.initialize()
        elif self.is_initialized and self.t1 < self.video.counter:
            self._update()

    def active_edges(self):
        """(ii, jj) numpy arrays of the active edge set."""
        return self.graph.ii.copy(), self.graph.jj.copy()

    def _update(self):
        """Keyframe step for the new keyframe t1 - 1."""
        cfg, graph = self.cfg, self.graph
        self.count += 1
        self.t1 += 1

        if graph.n > 0:
            with _T.phase("frontend.rm_stale"):
                graph.rm_factors(graph.age > cfg.max_age, store=True)

        with _T.phase("frontend.proximity"):
            graph.add_proximity_factors(
                self.t1 - 5, max(self.t1 - cfg.frontend_window, 0),
                rad=cfg.frontend_radius, nms=cfg.frontend_nms,
                thresh=cfg.frontend_thresh, beta=cfg.beta, remove=True)

        # seed the new keyframe's disparity from sensor depth
        st = self.video.state
        ds = st.disps_sens[self.t1 - 1]
        st.disps[self.t1 - 1] = torch.where(ds > 0, ds,
                                            st.disps[self.t1 - 1])

        for _ in range(cfg.frontend_iters1):
            graph.update(None, None, use_inactive=True)

        # the cull decision is a host read: it waits for the rounds
        with _T.phase("frontend.cull_check"):
            d = self.video.distance([self.t1 - 3], [self.t1 - 2],
                                    beta=cfg.beta, bidirectional=True)
            d = float(d[0].item())

        if d < cfg.keyframe_thresh:
            graph.rm_keyframe(self.t1 - 2)
            self.video.counter -= 1
            self.t1 -= 1
        else:
            for _ in range(cfg.frontend_iters2):
                graph.update(None, None, use_inactive=True)

        extrapolate(st, self.t1)

    def initialize(self):
        cfg = self.cfg
        self.t0 = 0
        self.t1 = self.video.counter

        self.graph.add_neighborhood_factors(self.t0, self.t1, r=3)
        for _ in range(8):
            self.graph.update(1, use_inactive=True)

        self.graph.add_proximity_factors(
            0, 0, rad=2, nms=2, thresh=cfg.frontend_thresh, remove=False)
        for _ in range(8):
            self.graph.update(1, use_inactive=True)

        st, t1 = self.video.state, self.t1
        st.poses[t1] = st.poses[t1 - 1]
        st.disps[t1] = st.disps[t1 - 4:t1].mean()

        self.is_initialized = True
        self.graph.rm_factors(self.graph.ii < cfg.warmup - 4, store=True)
