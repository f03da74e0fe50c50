"""Warmup bootstrap of the frontend.

After `warmup` keyframes: a temporal-neighborhood graph and 8 update
rounds, proximity edges and 8 more rounds, then the next pose/disparity
extrapolation.  The per-keyframe steps that follow run in
runtime/fused.py, which adopts this graph.
"""

from .factor_graph import FactorGraph


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
