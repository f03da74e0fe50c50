"""The per-keyframe frontend step and the per-frame tracking step.

The JAX package traces these into one device program per keyframe; here
they run eagerly, with host reads (`.item()`) for the keyframe and cull
decisions and host-side (numpy) edge bookkeeping.  The semantics are the
JAX package's and decide the trajectory:

    stale-edge retirement → proximity distance grid → NMS greedy edge
    selection → dedup / LRU-evict / insert → 4 update+BA rounds →
    keyframe-cull distance → cull (shift the map down) | keep (2 more
    rounds) → pose/disparity extrapolation

Slot model: edge stores hold an ACTIVE region [0, EA) that the update
operator processes and an INACTIVE ring [EA, EA+EI) with retired edges'
frozen target/weight; the ring overwrites its oldest entry when full.

Stereo: a frame's fmaps hold both cameras and an edge ii == jj correlates
the left camera with the right one.  RGB-D: the sensor depth of a new
keyframe seeds its disparity and is the dense BA's prior.  With
`upsample`, each update round convex-upsamples the solved disparities of
the frames it updated into `disps_up`.
"""

import dataclasses

import numpy as np
import torch

from ..geom import projective
from ..models.droidnet import normalize_images
from ..models.update import upsample_disp
from ..ops import corr as corr_ops
from ..ops import dba, distance
from ..utils.timers import span, sync_site
from .factor_graph import DAMPING_EPS, corr_pixel_chunk, edge_correlation
from .factor_graph import segment_ids, target_fmaps
from .motion_filter import as_image_batch
from .proximity import select_proximity_edges
from .state import disp_from_depth, keyframe_colors, pool_pyramid

_SEQ_MOD = 1 << 20      # LRU tie-break modulus (age ⋅ 2²⁰ + reversed seq)


@dataclasses.dataclass
class GraphState:
    """Factor graph of the per-keyframe step.

    ii/jj/target/weight span both regions; age/seq/active/net cover the
    active region.  Index bookkeeping is host numpy; rows are tensors.
    """

    ii: np.ndarray          # (EA+EI,) int64 source frame
    jj: np.ndarray          # (EA+EI,) int64 target frame
    age: np.ndarray         # (EA,) updates since insertion
    seq: np.ndarray         # (EA,) insertion sequence (LRU tie-break)
    active: np.ndarray      # (EA,) bool
    inac: np.ndarray        # (EI,) bool — ring slot holds a stored edge
    ring_ptr: int           # next ring write position
    tick: int               # global insertion counter
    target: torch.Tensor    # (EA+EI, h, w, 2) f32
    weight: torch.Tensor    # (EA+EI, h, w, 2) f32
    net: torch.Tensor       # (EA, h, w, 128) f32 GRU state

    @property
    def EA(self):
        return self.active.shape[0]

    @property
    def EI(self):
        return self.inac.shape[0]

    def exist(self):
        return np.concatenate([self.active, self.inac])


def init_graph_state(EA, EI, h, w, device):
    z = np.zeros
    return GraphState(
        ii=z(EA + EI, np.int64), jj=z(EA + EI, np.int64),
        age=z(EA, np.int64), seq=z(EA, np.int64),
        active=z(EA, bool), inac=z(EI, bool), ring_ptr=0, tick=0,
        target=torch.zeros((EA + EI, h, w, 2), device=device),
        weight=torch.zeros((EA + EI, h, w, 2), device=device),
        net=torch.zeros((EA, h, w, 128), device=device),
    )


def fused_caps(cfg):
    """Capacities derived from the config: (SRCP, TGTP, GC, P, K, EA, EI).

    SRCP/TGTP bound the proximity grid, GC the greedy steps; P/K the BA
    pose/depth windows (an edge survives ceil((max_age+1)/iters1) further
    keyframes; recent-inactive edges add up to 3 frames below t0).
    """
    window = cfg.frontend_window
    SRCP = 8
    TGTP = int(np.ceil((window + 7) / 8) * 8)
    GC = max(48, cfg.frontend_max_factors)
    survive = int(np.ceil((cfg.max_age + 1) / max(1, cfg.frontend_iters1)))
    kmax = window + 3 + survive
    P = K = max(32, int(np.ceil(kmax / 8) * 8))
    EA = max(64, int(np.ceil((cfg.frontend_max_factors + 16) / 8) * 8))
    EI = cfg.frontend_edge_cap
    return SRCP, TGTP, GC, P, K, EA, EI


def _rows(idx, device):
    with sync_site("h2d.rows"):
        return torch.as_tensor(np.asarray(idx, np.int64), device=device)


def _mask(mask, device):
    with sync_site("h2d.mask"):
        return torch.as_tensor(mask, device=device)


def retire(g, mask):
    """Move all masked active edges into the inactive ring, in slot order;
    when more retire at once than the ring holds, the newest wins."""
    src = np.nonzero(mask)[0]
    EA, EI = g.EA, g.EI
    pos = (g.ring_ptr + np.arange(len(src))) % EI
    final = dict(zip(pos.tolist(), src.tolist()))       # newest wins
    if final:
        p = np.asarray(list(final.keys()), np.int64)
        s = np.asarray(list(final.values()), np.int64)
        g.ii[EA + p] = g.ii[s]
        g.jj[EA + p] = g.jj[s]
        dst, sr = _rows(EA + p, g.target.device), _rows(s, g.target.device)
        g.target[dst] = g.target[sr]
        g.weight[dst] = g.weight[sr]
        g.inac[p] = True
    g.active = g.active & ~mask
    g.ring_ptr = int((g.ring_ptr + len(src)) % EI)
    return g


def insert_candidates(g, video, cand_i, cand_j, *, max_factors):
    """Dedup against existing edges, LRU-evict over the factor budget and
    write the surviving candidates into free active slots (the k-th new
    candidate takes the k-th free slot)."""
    EA = g.EA
    cand_i = np.asarray(cand_i, np.int64)
    cand_j = np.asarray(cand_j, np.int64)

    exist = g.exist()
    dup = np.any(exist[None, :] & (cand_i[:, None] == g.ii[None, :])
                 & (cand_j[:, None] == g.jj[None, :]), axis=1)
    new_valid = ~dup
    n_new = int(new_valid.sum())

    # LRU eviction by (age desc, insertion seq asc)
    n_active = int(g.active.sum())
    room = max_factors - n_active
    n_evict = (min(n_active, n_new - max(room, 0))
               if (n_new > room and n_active > 0) else 0)
    prio = g.age * _SEQ_MOD + (_SEQ_MOD - 1 - g.seq % _SEQ_MOD)
    prio = np.where(g.active, prio, -1)
    perm = np.argsort(-prio, kind="stable")
    rank = np.empty(EA, np.int64)
    rank[perm] = np.arange(EA)
    g = retire(g, g.active & (rank < n_evict))

    free = np.nonzero(~g.active)[0]
    new = np.nonzero(new_valid)[0][: len(free)]
    slots = free[: len(new)]
    if len(new) == 0:
        return g
    ci, cj = cand_i[new], cand_j[new]
    g.ii[slots] = ci
    g.jj[slots] = cj
    g.age[slots] = 0
    g.seq[slots] = g.tick + np.arange(len(new))
    g.tick += len(new)
    g.active[slots] = True

    dev = g.target.device
    s, ci_t, cj_t = _rows(slots, dev), _rows(ci, dev), _rows(cj, dev)
    tgt, _ = video.reproject(ci_t, cj_t)
    g.net[s] = video.state.nets[ci_t].float()
    g.target[s] = tgt
    with sync_site("h2d.const"):
        g.weight[s] = 0.0
    return g


def build_kx(ii, mask_ba, t0, t1b, buf, K):
    """Depth-frame list kx = [t0, t1b) ∪ {ii of BA edges}, ascending,
    truncated to K members."""
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


def volume_cache_fits(cfg, EA, ht, wd):
    """Does the per-edge volume pyramid (EA · ht·wd · Σ_l h2_l·w2_l bf16)
    fit the cache budget?"""
    if cfg.corr_cache_mb <= 0:
        return False
    tgt = 0
    h2, w2 = ht, wd
    for _ in range(corr_ops.NUM_LEVELS):
        tgt += h2 * w2
        h2, w2 = h2 // 2, w2 // 2
    return EA * ht * wd * tgt * 2 <= cfg.corr_cache_mb * 1_000_000


def edge_volumes(fmaps, ii, jj):
    """Per-edge correlation-volume pyramid in the lookup kernel's
    query-major layout: list of (E, h·w, h2_l, w2_l) bf16 — a query's
    plane is contiguous — each an f32 matmul rounded to bf16.  A stereo
    edge ii == jj correlates with the right camera."""
    E, _, h, w, C = fmaps[ii].shape
    f1 = fmaps[ii, 0].float().reshape(E, h * w, C) / 4.0
    vols = []
    for p in pool_pyramid(target_fmaps(fmaps, ii, jj)):
        h2, w2 = p.shape[1:3]
        f2 = p.float().reshape(E, h2 * w2, C) / 4.0
        v = torch.bmm(f1, f2.transpose(1, 2)).to(torch.bfloat16)
        vols.append(v.reshape(E, h * w, h2, w2))
    return vols


class KeyframeStep:
    """The per-keyframe frontend update on (video, graph state)."""

    def __init__(self, net, cfg, video):
        self.net = net
        self.cfg = cfg
        self.video = video
        (self.SRCP, self.TGTP, self.GC, self.P, self.K, self.EA,
         self.EI) = fused_caps(cfg)
        self.cache_vols = volume_cache_fits(cfg, self.EA, video.fht,
                                            video.fwd)

    def update_op(self, g, act, vols=None):
        """Update operator over the active edge slots `act` (non-empty):
        new GRU state, targets and weights, and the damping of their
        source frames.  Returns (source frames, upsampling mask or
        None)."""
        cfg, video = self.cfg, self.video
        st = video.state
        ht, wd = video.fht, video.fwd
        dev = video.device
        a = _rows(act, dev)
        ii_a, jj_a = _rows(g.ii[act], dev), _rows(g.jj[act], dev)
        coords1, _ = projective.projective_transform(
            st.poses[None], st.disps[None], st.intrinsics[None],
            ii_a, jj_a)
        coords1 = coords1[0]
        coords0 = projective.coords_grid(ht, wd, device=dev)
        motn = torch.clamp(torch.cat(
            [coords1 - coords0, g.target[a] - coords1], dim=-1),
            -64.0, 64.0)
        with span("round.corr"):
            if vols is not None:
                corr = corr_ops.lookup_pyramid_flat(
                    vols, coords1.reshape(len(act), ht * wd, 2)
                ).reshape(len(act), ht, wd, -1)
            else:
                corr = edge_correlation(
                    st.fmaps, ii_a, jj_a, coords1,
                    corr_pixel_chunk(cfg, self.EA, ht * wd))
        ix, frames = segment_ids(ii_a)
        with span("round.update_op"):
            out = self.net.update(
                g.net[a], st.inps[ii_a], corr, motn, ix=ix,
                nseg=len(frames), with_upmask=cfg.upsample)
            net_new, delta, weight, eta = out[:4]
            g.net[a] = net_new.float()
            g.target[a] = coords1 + delta
            g.weight[a] = weight
            st.damping[frames] = eta
        return frames, (out[4] if cfg.upsample else None)

    def update_round(self, g, vols=None):
        """Update operator over the active edges, then dense BA over
        active ∪ recent-inactive edges; under `upsample`, the solved
        disparities of the updated frames go through the convex
        upsampling into `disps_up`."""
        with span("keyframe.round"):
            cfg, video = self.cfg, self.video
            st = video.state
            buf = cfg.buffer
            dev = video.device
            act = np.nonzero(g.active)[0]
            if len(act):
                frames, upmask = self.update_op(g, act, vols)

            # dense BA over active ∪ recent-inactive edges
            ii_act, jj_act = g.ii[act], g.jj[act]
            t0 = max(1, (int(ii_act.min()) if len(act) else buf + 1) + 1)
            t1b = (int(np.maximum(ii_act, jj_act).max()) if len(act)
                   else -1) + 1
            recent = (g.ii >= t0 - 3) & (g.jj >= t0 - 3)
            mask_ba = g.exist() & recent
            mask_ba[: g.EA] = g.active
            kx, kmask = build_kx(g.ii, mask_ba, t0, t1b, buf, self.K)
            eta = 0.2 * st.damping + DAMPING_EPS
            with span("round.ba"):
                poses, disps = dba.ba(
                    st.poses, st.disps, st.disps_sens, st.intrinsics,
                    g.target, g.weight, eta, _rows(g.ii, dev),
                    _rows(g.jj, dev), _mask(mask_ba, dev), _rows(kx, dev),
                    _mask(kmask, dev), t0, t1b, iters=cfg.ba_iters,
                    lm=cfg.frontend_lm, ep=cfg.frontend_ep, P=self.P)
                # divergence guard: revert the whole round on non-finite
                # output
                ok = (torch.isfinite(poses.sum())
                      & torch.isfinite(disps.sum()))
                st.poses.copy_(torch.where(ok, poses, st.poses))
                st.disps.copy_(torch.where(ok, disps, st.disps))
            g.age = np.where(g.active, g.age + 1, g.age)
            if len(act) and cfg.upsample:
                st.disps_up[frames] = upsample_disp(st.disps[frames],
                                                    upmask.float())
            return g

    def select_candidates(self, g, t1):
        """Proximity candidates for the new keyframe t1-1."""
        cfg, st = self.cfg, self.video.state
        t0p = t1 - 5
        t1p = max(t1 - cfg.frontend_window, 0)
        rows = np.arange(max(t0p, 0), t1)
        cols = np.arange(t1p, t1)
        d = np.full((t1 - t0p, t1 - t1p), np.inf, np.float32)
        if len(rows) and len(cols):
            gi, gj = np.meshgrid(rows, cols, indexing="ij")
            dev = self.video.device
            dd = distance.frame_distance(
                st.poses, st.disps, st.intrinsics[0],
                _rows(gi.reshape(-1), dev), _rows(gj.reshape(-1), dev),
                cfg.beta)
            with sync_site("proximity.cpu"):
                d[rows[0] - t0p:] = dd.cpu().numpy().reshape(gi.shape)
        exist = g.exist()
        return select_proximity_edges(
            d, t0p, t1p, t1, g.ii[exist], g.jj[exist],
            cfg.frontend_radius, cfg.frontend_nms, cfg.frontend_thresh,
            cfg.frontend_max_factors, cfg.stereo, max_steps=self.GC)

    def __call__(self, g, t1):
        """Keyframe update for the new keyframe t1-1; returns (g, cull)."""
        cfg, video = self.cfg, self.video
        st = video.state

        # 1. retire stale edges (archived in the ring)
        with span("keyframe.retire"):
            g = retire(g, g.active & (g.age > cfg.max_age))

        # 2. proximity edges
        with span("keyframe.proximity"):
            ci, cj = self.select_candidates(g, t1)
        with span("keyframe.insert"):
            g = insert_candidates(g, video, ci, cj,
                                  max_factors=cfg.frontend_max_factors)

        # 3. seed the new keyframe's disparity from sensor depth
        ds = st.disps_sens[t1 - 1]
        st.disps[t1 - 1] = torch.where(ds > 0, ds, st.disps[t1 - 1])

        # 4. mandatory rounds; the edge set and fmaps are fixed for the
        # rest of the step, so the volume pyramid is built once
        vols = None
        if self.cache_vols and g.active.any():
            with span("keyframe.volumes"):
                act = np.nonzero(g.active)[0]
                vols = edge_volumes(st.fmaps,
                                    _rows(g.ii[act], video.device),
                                    _rows(g.jj[act], video.device))
        for _ in range(cfg.frontend_iters1):
            g = self.update_round(g, vols)
        del vols

        # 5. keyframe cull check
        with span("keyframe.cull"):
            dev = video.device
            dc = distance.frame_distance(
                st.poses, st.disps, st.intrinsics[0],
                _rows([t1 - 3, t1 - 2], dev), _rows([t1 - 2, t1 - 3], dev),
                cfg.beta)
            with sync_site("cull.item"):
                cull = bool((0.5 * (dc[0] + dc[1])
                             < cfg.keyframe_thresh).item())
            if cull:
                ix = t1 - 2
                video.copy_slot(ix, ix + 1)
                touch = g.exist() & ((g.ii == ix) | (g.jj == ix))
                g.ii = np.where(g.ii >= ix, g.ii - 1, g.ii)
                g.jj = np.where(g.jj >= ix, g.jj - 1, g.jj)
                g.active = g.active & ~touch[: g.EA]
                g.inac = g.inac & ~touch[g.EA:]
                extrapolate(st, t1 - 1)
        if not cull:
            for _ in range(cfg.frontend_iters2):
                g = self.update_round(g)
            extrapolate(st, t1)
        return g, int(cull)


def extrapolate(st, tx):
    """Next-keyframe initialization: pose[tx] = pose[tx-1], disp[tx] =
    mean disp[tx-1]."""
    if tx < st.poses.shape[0]:
        st.poses[tx] = st.poses[tx - 1]
        st.disps[tx] = st.disps[tx - 1].mean()


class FusedFrontend:
    """Frontend after warmup: the per-frame tracking step (motion gate +
    conditional keyframe append + keyframe step).  The warmup bootstrap
    runs on the host-driven factor graph (runtime/frontend.py) and is
    adopted into the GraphState."""

    def __init__(self, net, video, cfg):
        self.net = net
        self.video = video
        self.cfg = cfg
        self.t1 = 0
        self.filter_thresh = cfg.filter_thresh
        self.is_initialized = False
        self.step = KeyframeStep(net, cfg, video)
        self.g = init_graph_state(self.step.EA, self.step.EI, video.fht,
                                  video.fwd, video.device)

    def __call__(self):
        if not self.is_initialized and self.video.counter == self.cfg.warmup:
            self._initialize()

    def active_edges(self):
        """(ii, jj) numpy arrays of the active edge set."""
        act = self.g.active
        return self.g.ii[: self.g.EA][act], self.g.jj[: self.g.EA][act]

    @torch.no_grad()
    def track_frame(self, tstamp, image, depth=None, intrinsics=None,
                    fmap=None, ctx=None):
        """Motion gate vs the last keyframe; on a keyframe, append it and
        run the keyframe step.  image: (H, W, 3), or (2, H, W, 3) [left,
        right] for stereo; depth: optional (H, W) metric sensor depth.
        fmap/ctx: precomputed features (batch mode).  Returns True when
        the frame became a keyframe."""
        with span("track.frame"):
            cfg, video = self.cfg, self.video
            st = video.state
            with span("track.encode"):
                image = as_image_batch(image, video.device)
                x = normalize_images(image)
                if fmap is None:
                    fmap = self.net.fnet(x)
            c = video.counter
            if c >= cfg.buffer - 1:
                raise RuntimeError(
                    f"keyframe buffer nearly full ({c}/{cfg.buffer}); "
                    f"increase SLAMConfig.buffer for this sequence")

            # motion gate: window correlation at the identity grid + one
            # update step vs the last keyframe
            with span("track.gate"):
                f1 = st.fmaps[c - 1, 0:1].float() / 4.0
                f2_pyr = pool_pyramid(fmap[0:1].float() / 4.0)
                corr = corr_ops.gate_corr_pyramid(f1, f2_pyr)
                _, delta, _ = self.net.update(st.nets[c - 1][None],
                                              st.inps[c - 1][None], corr)
                dmag = torch.mean(torch.linalg.norm(delta, dim=-1))
                with sync_site("gate.item"):
                    keep = bool((dmag > self.filter_thresh).item())
            if not keep:
                return False

            with span("track.context"):
                if ctx is None:
                    netc, inpc = self.net.context(x[0:1])
                    netc, inpc = netc[0], inpc[0]
                else:
                    netc, inpc = ctx
                with sync_site("h2d.const"):
                    st.tstamp[c] = float(tstamp)
                with sync_site("h2d.disps_sens"):
                    st.disps_sens[c] = torch.as_tensor(
                        disp_from_depth(depth, (video.fht, video.fwd)))
                with sync_site("h2d.intrinsics"):
                    st.intrinsics[c] = torch.as_tensor(
                        intrinsics, dtype=torch.float32) / 8.0
                st.fmaps[c] = fmap.to(torch.bfloat16)
                st.nets[c] = netc.to(st.nets.dtype)
                st.inps[c] = inpc.to(st.inps.dtype)
                st.colors[c] = keyframe_colors(image)
            video.counter = c + 1
            self.t1 += 1
            with span("keyframe.step"):
                self.g, cull = self.step(self.g, self.t1)
            video.counter -= cull
            self.t1 -= cull
            return True

    @torch.no_grad()
    def track_frames(self, tstamps, images, intrinsics=None):
        """Batch mode: fnet and cnet run once over the whole chunk, then
        the per-frame steps follow in order.  No sensor depth."""
        imgs = torch.stack([torch.as_tensor(np.asarray(im))
                            for im in images]).to(self.video.device)
        if imgs.ndim == 4:
            imgs = imgs[:, None]
        B, rig = imgs.shape[:2]
        x = normalize_images(imgs.reshape((B * rig,) + imgs.shape[2:]))
        fmaps = self.net.fnet(x).reshape((B, rig) + (self.video.fht,
                                                     self.video.fwd, 128))
        nets, inps = self.net.context(x[::rig])
        for b in range(B):
            self.track_frame(tstamps[b], imgs[b], intrinsics=intrinsics,
                             fmap=fmaps[b], ctx=(nets[b], inps[b]))

    def _initialize(self):
        from .frontend import Frontend

        boot = Frontend(self.net, self.video, self.cfg)
        boot.initialize()
        self.t1 = boot.t1
        self.is_initialized = True
        self.adopt(boot.graph)

    def adopt(self, graph):
        """Convert the boot FactorGraph into the GraphState regions."""
        g = self.g
        EA, EI = g.EA, g.EI
        n = len(graph.ii)
        if n > EA:
            raise RuntimeError(f"{n} boot edges exceed active capacity {EA}")
        dev = self.video.device
        g.ii[:n] = graph.ii
        g.jj[:n] = graph.jj
        g.age[:n] = graph.age
        g.seq[:n] = np.arange(n)
        g.active[:n] = True
        s = _rows(graph.slots, dev)
        g.net[:n] = graph.net_state[s].float()
        g.target[:n] = graph.target[s]
        g.weight[:n] = graph.weight[s]

        n_i = min(len(graph.ii_inac), EI)
        start = len(graph.ii_inac) - n_i
        g.ii[EA:EA + n_i] = graph.ii_inac[start:]
        g.jj[EA:EA + n_i] = graph.jj_inac[start:]
        g.inac[:n_i] = True
        g.target[EA:EA + n_i] = graph.target_inac[start:start + n_i]
        g.weight[EA:EA + n_i] = graph.weight_inac[start:start + n_i]
        g.ring_ptr = n_i % EI
        g.tick = n
