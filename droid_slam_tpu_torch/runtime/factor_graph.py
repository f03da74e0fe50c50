"""Covisibility factor graph driven from the host.

Serves the host-driven frontend and its warmup bootstrap
(runtime/frontend.py), the global-BA backend and the trajectory filler.
Edge bookkeeping (slot allocation, dedup, LRU eviction, proximity
selection, keyframe removal) is numpy on the host; per-edge GRU state,
targets and weights live in slot-indexed device tensors, and the
inactive store's rows sit beside the host lists `ii_inac`/`jj_inac`, row
k for edge k.

Slots are handed out from a free list that grows in power-of-two steps up
to the edge capacity, and the update operator runs over the slots in
chunks of `chunk`: the chunk decides which edges GraphAgg averages
together, so the port keeps the JAX package's slot order exactly.
Correlation is computed on the fly every update (ops/corr.py
alt_lookup_pyramid); a stereo edge ii == jj correlates the left camera
with the right one.  With `upsample` each chunk also convex-upsamples the
disparities of its source frames into `disps_up`, with GraphAgg's mask.
"""

import numpy as np
import torch

from ..geom import projective
from ..models.update import upsample_disp
from ..ops import corr as corr_ops
from ..utils.mem import log_mem
from ..utils.timers import span, sync_site
from .proximity import select_proximity_edges
from .state import pool_pyramid

DAMPING_EPS = 1e-7    # EP of the reference's factor_graph.update


def corr_pixel_chunk(cfg, edge_chunk, hw):
    """Low-memory pixel blocking for the on-the-fly correlation: explicit
    cfg.corr_pixel_chunk, or auto when the level-0 volume transient
    (edge_chunk · hw² bf16) would exceed ~0.6 GB."""
    if cfg.corr_pixel_chunk > 0:
        return cfg.corr_pixel_chunk
    if edge_chunk * hw * hw * 2 > 600_000_000:
        return 512
    return 0


def segment_ids(ii):
    """Per-source-frame GraphAgg segments of an edge list: (ix, frames)."""
    with sync_site("segments.unique"):
        frames, ix = torch.unique(ii, return_inverse=True)
    return ix, frames


def target_fmaps(fmaps, ii, jj):
    """(E, h, w, 128) target features of edges (ii, jj) from the
    (BUF, rig, h, w, 128) store: frame jj's left camera, and on a stereo
    edge ii == jj its right camera (the last of the rig)."""
    return fmaps[jj, (ii == jj).long() * (fmaps.shape[1] - 1)]


def edge_correlation(fmaps, ii, jj, coords1, pixel_chunk=0):
    """On-the-fly correlation pyramid of edges (ii, jj) at coords1
    (E, h, w, 2): features from the bf16 frame store, pooled per level."""
    f1 = fmaps[ii, 0].float() / 4.0
    f2 = [p.float() / 4.0
          for p in pool_pyramid(target_fmaps(fmaps, ii, jj))]
    return corr_ops.alt_lookup_pyramid(f1, f2, coords1,
                                       pixel_chunk=pixel_chunk)


class FactorGraph:
    def __init__(self, video, net, max_factors=48, edge_cap=None,
                 inac_cap=None, pose_cap=None, depth_cap=None,
                 update_chunk=None, state_dtype=torch.float32,
                 upsample=False):
        self.video = video
        self.net = net
        self.cfg = video.cfg
        self.dev = video.device
        self.max_factors = max_factors
        self.upsample = upsample
        self.ht, self.wd = video.fht, video.fwd
        # optional BA override fn(target, weight, eta, ii, jj, mask, t0,
        # t1) for the global sweeps: the backend routes them through the
        # edge-sharded solver (parallel/dba.py) with it
        self.ba_fn = None

        self.E = edge_cap or max(self.cfg.frontend_edge_cap, max_factors + 16)
        self.I = inac_cap if inac_cap is not None else min(self.E, 256)
        self.P = pose_cap or self.cfg.frontend_pose_cap
        self.K = depth_cap or self.cfg.frontend_depth_cap
        self.chunk = update_chunk or min(self.E, 64)
        self.state_dtype = state_dtype

        z = np.zeros(0, np.int64)
        self.ii, self.jj, self.age, self.slots = z, z, z, z
        self.ii_inac, self.jj_inac = z, z

        ht, wd = self.ht, self.wd
        self.E_alloc = 0
        self.free = []
        self.net_state = torch.zeros((0, ht, wd, 128), dtype=state_dtype,
                                     device=self.dev)
        self.target = torch.zeros((0, ht, wd, 2), device=self.dev)
        self.weight = torch.zeros((0, ht, wd, 2), device=self.dev)
        self._grow(min(self.E, max(self.chunk, 64)))
        self.target_inac = torch.zeros((self.I, ht, wd, 2), device=self.dev)
        self.weight_inac = torch.zeros((self.I, ht, wd, 2), device=self.dev)

    def _grow(self, need):
        """Grow the slot-indexed stores to hold `need` edges (next
        power-of-two bucket, capped at self.E)."""
        if need <= self.E_alloc:
            return
        new = max(self.E_alloc, 1)
        while new < need:
            new *= 2
        new = min(new, self.E)
        if new <= self.E_alloc:
            return

        def grow(x):
            out = x.new_zeros((new,) + x.shape[1:])
            out[: x.shape[0]] = x
            return out

        self.net_state = grow(self.net_state)
        self.target = grow(self.target)
        self.weight = grow(self.weight)
        self.free.extend(range(self.E_alloc, new))
        self.E_alloc = new

    # -- host bookkeeping -------------------------------------------------

    @property
    def n(self):
        return len(self.ii)

    def _edge_arrays(self):
        """(E_alloc,) slot-indexed ii/jj arrays + validity mask."""
        ii = np.zeros(self.E_alloc, np.int64)
        jj = np.zeros(self.E_alloc, np.int64)
        mask = np.zeros(self.E_alloc, bool)
        ii[self.slots] = self.ii
        jj[self.slots] = self.jj
        mask[self.slots] = True
        return ii, jj, mask

    def _dedup(self, ii, jj):
        """Drop pairs already present (active or inactive)."""
        existing = set(zip(self.ii.tolist(), self.jj.tolist())) | set(
            zip(self.ii_inac.tolist(), self.jj_inac.tolist()))
        keep = [k for k, (i, j) in enumerate(zip(ii, jj))
                if (int(i), int(j)) not in existing]
        return np.asarray(ii)[keep], np.asarray(jj)[keep]

    def _t(self, x):
        return torch.as_tensor(np.asarray(x, np.int64), device=self.dev)

    # -- update operator --------------------------------------------------

    def _run_update_op(self):
        """Update operator over all edge slots, chunk by chunk."""
        st = self.video.state
        ii, jj, mask = self._edge_arrays()
        ht, wd = self.ht, self.wd
        coords0 = projective.coords_grid(ht, wd, device=self.dev)
        pc = corr_pixel_chunk(self.cfg, self.chunk, ht * wd)

        for lo in range(0, self.E_alloc, self.chunk):
            sl = np.nonzero(mask[lo:lo + self.chunk])[0] + lo
            if len(sl) == 0:
                continue
            s = self._t(sl)
            ii_c, jj_c = self._t(ii[sl]), self._t(jj[sl])
            coords1, _ = projective.projective_transform(
                st.poses[None], st.disps[None], st.intrinsics[None],
                ii_c, jj_c)
            coords1 = coords1[0]
            motn = torch.clamp(torch.cat(
                [coords1 - coords0, self.target[s] - coords1], dim=-1),
                -64.0, 64.0)
            corr = edge_correlation(st.fmaps, ii_c, jj_c, coords1, pc)

            ix, frames = segment_ids(ii_c)
            out = self.net.update(
                self.net_state[s], st.inps[ii_c], corr, motn,
                ix=ix, nseg=len(frames), with_upmask=self.upsample)
            net_new, delta, weight, eta = out[:4]
            self.net_state[s] = net_new.to(self.state_dtype)
            self.target[s] = coords1 + delta
            self.weight[s] = weight
            st.damping[frames] = eta
            if self.upsample:
                # the chunk's source frames, from the disparities this
                # round's BA starts from
                st.disps_up[frames] = upsample_disp(st.disps[frames],
                                                    out[4].float())

    # -- graph edits ------------------------------------------------------

    def add_factors(self, ii, jj, remove=False):
        """Add edges: dedup, LRU-evict over the factor budget, seed the
        GRU state from the source frame's context features and targets by
        reprojection."""
        ii = np.asarray(ii, np.int64).reshape(-1)
        jj = np.asarray(jj, np.int64).reshape(-1)
        ii, jj = self._dedup(ii, jj)
        if len(ii) == 0:
            return

        room = self.max_factors - self.n if self.max_factors > 0 else len(ii)
        if self.max_factors > 0 and len(ii) > room and self.n > 0 and remove:
            n_evict = min(self.n, len(ii) - max(room, 0))
            order = np.argsort(-self.age)
            evict_mask = np.zeros(self.n, bool)
            evict_mask[order[:n_evict]] = True
            self.rm_factors(evict_mask, store=True)
        if self.n + len(ii) > self.E:
            keep = self.E - self.n
            ii, jj = ii[:keep], jj[:keep]
        if len(ii) == 0:
            return

        self._grow(self.n + len(ii))
        slots = np.asarray([self.free.pop() for _ in ii], np.int64)
        s, ii_t, jj_t = self._t(slots), self._t(ii), self._t(jj)
        new_target, _ = self.video.reproject(ii_t, jj_t)
        self.net_state[s] = self.video.state.nets[ii_t].to(self.state_dtype)
        self.target[s] = new_target
        self.weight[s] = 0.0

        self.ii = np.concatenate([self.ii, ii])
        self.jj = np.concatenate([self.jj, jj])
        self.age = np.concatenate([self.age, np.zeros(len(ii), np.int64)])
        self.slots = np.concatenate([self.slots, slots])

    def rm_factors(self, mask, store=False):
        """Remove masked edges; with store=True archive their targets and
        weights in the inactive store while it has room."""
        mask = np.asarray(mask, bool)
        if mask.sum() == 0:
            return
        drop = np.nonzero(mask)[0]
        keep = ~mask

        if store:
            n_inac = len(self.ii_inac)
            take = min(len(drop), self.I - n_inac)
            if take > 0:
                src = self._t(self.slots[drop[:take]])
                dst = self._t(np.arange(take) + n_inac)
                self.target_inac[dst] = self.target[src]
                self.weight_inac[dst] = self.weight[src]
                self.ii_inac = np.concatenate(
                    [self.ii_inac, self.ii[drop[:take]]])
                self.jj_inac = np.concatenate(
                    [self.jj_inac, self.jj[drop[:take]]])

        self.free.extend(int(s) for s in self.slots[drop])
        self.ii = self.ii[keep]
        self.jj = self.jj[keep]
        self.age = self.age[keep]
        self.slots = self.slots[keep]

    def rm_keyframe(self, ix):
        """Drop keyframe ix: slot ix+1 moves into it (`copy_slot`), edges
        touching ix go, and every index above ix shifts down by one, in
        the inactive store too (its rows compacted with its lists)."""
        self.video.copy_slot(ix, ix + 1)

        m = (self.ii_inac == ix) | (self.jj_inac == ix)
        self.ii_inac = np.where(self.ii_inac >= ix, self.ii_inac - 1,
                                self.ii_inac)
        self.jj_inac = np.where(self.jj_inac >= ix, self.jj_inac - 1,
                                self.jj_inac)
        if m.any():
            keep = np.nonzero(~m)[0]
            rows = self._t(keep)
            self.target_inac[: len(keep)] = self.target_inac[rows]
            self.weight_inac[: len(keep)] = self.weight_inac[rows]
            self.ii_inac = self.ii_inac[keep]
            self.jj_inac = self.jj_inac[keep]

        m = (self.ii == ix) | (self.jj == ix)
        self.ii = np.where(self.ii >= ix, self.ii - 1, self.ii)
        self.jj = np.where(self.jj >= ix, self.jj - 1, self.jj)
        self.rm_factors(m, store=False)

    # -- update + BA rounds -----------------------------------------------

    def update(self, t0=None, t1=None, itrs=2, use_inactive=False,
               motion_only=False):
        """One update-operator + BA round."""
        if self.n == 0:
            return
        with span("graph.update_op"):
            self._run_update_op()
        if t0 is None:
            t0 = max(1, int(self.ii.min()) + 1)
        with span("graph.ba"):
            self._ba(t0, t1, itrs, use_inactive, motion_only)
        self.age += 1

    def update_lowmem(self, steps=8):
        """Global BA sweeps with the backend damping profile."""
        t = self.video.counter
        for step in range(steps):
            if self.n == 0:
                return
            with span("graph.update_op"):
                self._run_update_op()
            if step == 0:
                log_mem("update_lowmem: first update sweep", self.dev)
            eta = 0.2 * self.video.state.damping + DAMPING_EPS
            ii, jj, mask = self._edge_arrays()
            with span("graph.ba"):
                if self.ba_fn is not None:
                    self.ba_fn(self.target, self.weight, eta, ii, jj, mask,
                               1, t)
                else:
                    self.video.ba(
                        self.target, self.weight, eta, ii, jj, mask, 1, t,
                        itrs=self.cfg.ba_iters, lm=self.cfg.backend_lm,
                        ep=self.cfg.backend_ep, motion_only=False,
                        pose_cap=self.P, depth_cap=self.K)

    def _ba(self, t0, t1, itrs, use_inactive, motion_only):
        """BA over the active edges plus the newest recent inactive ones."""
        ii, jj, mask = self._edge_arrays()
        if use_inactive and len(self.ii_inac) > 0:
            m = (self.ii_inac >= t0 - 3) & (self.jj_inac >= t0 - 3)
        else:
            m = np.zeros(len(self.ii_inac), bool)
        sel = np.nonzero(m)[0][-self.I:]
        st = self._t(sel)

        ii_all = np.concatenate([self.ii_inac[sel], ii])
        jj_all = np.concatenate([self.jj_inac[sel], jj])
        mask_all = np.concatenate([np.ones(len(sel), bool), mask])
        target_all = torch.cat([self.target_inac[st], self.target])
        weight_all = torch.cat([self.weight_inac[st], self.weight])

        if t1 is None:
            t1 = int(max(self.ii.max(), self.jj.max())) + 1

        eta = 0.2 * self.video.state.damping + DAMPING_EPS
        self.video.ba(
            target_all, weight_all, eta, ii_all, jj_all, mask_all,
            int(t0), int(t1), itrs=itrs, lm=self.cfg.frontend_lm,
            ep=self.cfg.frontend_ep, motion_only=motion_only,
            pose_cap=self.P, depth_cap=self.K)

    # -- graph construction policies ---------------------------------------

    def add_neighborhood_factors(self, t0, t1, r=3):
        """All pairs within temporal radius r."""
        ii, jj = np.meshgrid(np.arange(t0, t1), np.arange(t0, t1),
                             indexing="ij")
        ii, jj = ii.reshape(-1), jj.reshape(-1)
        c = 1 if self.cfg.stereo else 0
        keep = (np.abs(ii - jj) > c) & (np.abs(ii - jj) <= r)
        self.add_factors(ii[keep], jj[keep])

    def add_proximity_factors(self, t0=0, t1=0, rad=2, nms=2, beta=0.25,
                              thresh=16.0, remove=False):
        """Distance-sorted greedy edge selection with Manhattan NMS."""
        t = self.video.counter
        ix = np.arange(t0, t)
        jx = np.arange(t1, t)
        if len(ix) == 0 or len(jx) == 0:
            return
        ii_g, jj_g = np.meshgrid(ix, jx, indexing="ij")
        with span("graph.distance"):
            d = self.video.distance(ii_g.reshape(-1), jj_g.reshape(-1),
                                    beta=beta, bidirectional=False)
            with sync_site("proximity.cpu"):
                d = d.cpu().numpy().reshape(len(ix), len(jx))
        max_f = self.max_factors if self.max_factors > 0 else 1 << 40
        ii_sel, jj_sel = select_proximity_edges(
            d, t0, t1, t,
            np.concatenate([self.ii, self.ii_inac]),
            np.concatenate([self.jj, self.jj_inac]),
            rad, nms, thresh, max_f, self.cfg.stereo)
        if len(ii_sel):
            with span("graph.insert"):
                self.add_factors(ii_sel, jj_sel, remove)
