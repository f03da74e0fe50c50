"""Tracking cells: `Droid.track` fed a rendered sequence in a closed loop.

Set-up renders the traffic on the device and hands the frames over as
host uint8 arrays, builds `Droid` with the configuration's weights, loads
its kernels, runs the update operator once at every edge count the
keyframe step can use (so that no convolution plan is made in the
window), and tracks the first `setup_frames` frames (the boot and the
first keyframe steps).  The window then hands in one frame at a time:
the next frame goes in when `track` has returned and the card is
synchronized, as the evaluation scripts feed a sequence.

For `correct` it keeps, from the window, the program's outputs of a few
update rounds (with its state just before each), of a few motion-gate
calls, and the features of a few keyframes, all drawn from the seed over
the whole window (a reservoir sample of the rounds and of the frames as
they pass); the plain reference (benchmark/reference/tracking.py)
recomputes them once the window has closed and the program is freed.
"""

import copy
import gc
import os

import numpy as np
import torch

from benchmark.runners.common import (compared, free, memory_peak, now_ns,
                                      rel_gap, reset_peak, sync)
from benchmark.lib import costs, loader
from benchmark.lib.spans import Spans
from benchmark.lib.trace import DeviceTrace, summarize
from benchmark.reference import precision
from benchmark.reference import tracking as ref
from benchmark.reference.weights import load_net


def slam_config(conf):
    from droid_slam_tpu_torch.config import SLAMConfig

    return SLAMConfig(**{k: tuple(v) if isinstance(v, list) else v
                         for k, v in conf["slam"].items()})


def warm_update(droid, cfg):
    """The update operator at every edge count 1..EA with as many GraphAgg
    segments, and once without (the gate's call)."""
    from droid_slam_tpu_torch.runtime.fused import fused_caps

    EA = fused_caps(cfg)[5]
    h, w = droid.video.fht, droid.video.fwd
    dev, dt = droid.device, droid.video.state.inps.dtype
    with torch.no_grad():
        for E in range(1, EA + 1):
            z = torch.zeros((E, h, w, 128), device=dev)
            droid.net.update(z, z.to(dt), torch.zeros((E, h, w, 196),
                                                      device=dev),
                             torch.zeros((E, h, w, 4), device=dev),
                             ix=torch.arange(E, device=dev), nseg=E,
                             with_upmask=cfg.upsample)
        droid.net.update(z[:1], z[:1].to(dt), torch.zeros((1, h, w, 196),
                                                          device=dev))
    sync(dev)


class Reservoir:
    """A uniform sample of `k` items from a stream of unknown length
    (algorithm R), drawn from `rng`."""

    def __init__(self, k, rng):
        self.k, self.rng = k, rng
        self.seen = 0
        self.items = []

    def slot(self):
        """Where the stream's next item goes, or None if it is not kept."""
        n = self.seen
        self.seen += 1
        if n < self.k:
            self.items.append(None)
            return n
        j = int(self.rng.integers(0, n + 1))
        return j if j < self.k else None


class Probe:
    """Hooks on the program's instances: spans, model FLOPs, and the
    samples the check compares."""

    def __init__(self, droid, seed, sample, trace):
        self.droid = droid
        self.spans = Spans()
        self.flops = 0
        self.lookups = []
        self.trace = trace
        self.window = False
        self.first_round = False
        self.gate_want = None
        self.rounds = Reservoir(sample["rounds"],
                                np.random.default_rng([seed, 2]))
        self.gates = Reservoir(sample["gates"],
                               np.random.default_rng([seed, 3]))
        step = droid.frontend.step
        step.update_round = self.spans.wrap("update_round",
                                            self._round(step.update_round))
        step.update_op = self.spans.wrap("update_operator", step.update_op)
        net = droid.net
        net.update.register_forward_hook(self._update_hook, with_kwargs=True)
        if trace:
            net.fnet.register_forward_hook(self._encoder_hook(128))
            net.cnet.register_forward_hook(self._encoder_hook(256))

    def _encoder_hook(self, out_dim):
        def hook(mod, args, out):
            if self.window:
                x = args[0]
                n = x.numel() // (x.shape[-3] * x.shape[-2] * 3)
                self.flops += n * costs.encoder_flops(x.shape[-3],
                                                      x.shape[-2], out_dim)
        return hook

    def _update_hook(self, mod, args, kwargs, out):
        if not self.window:
            return
        gate = kwargs.get("ix") is None
        net = args[0]
        E, h, w = net.shape[:3]
        if self.trace:
            self.flops += costs.update_flops(
                E, h, w, 0 if gate else kwargs["nseg"],
                kwargs.get("with_upmask", False))
            if gate:
                self.flops += costs.gate_corr_flops(h, w)
            elif self.first_round:
                self.flops += costs.volume_flops(E, h, w)
                self.first_round = False
        if gate and self.gate_want is not None:
            slot, want = self.gate_want
            want["delta"] = out[1].float().clone()
            self.gates.items[slot] = want
            self.gate_want = None

    def before_frame(self, t):
        """Called before the window hands in frame `t`."""
        self.first_round = True
        self.gate_want = None
        slot = self.gates.slot()
        if slot is not None:
            st, c = self.droid.video.state, self.droid.video.counter
            self.gate_want = (slot, dict(frame=t,
                                         keyframe=int(st.tstamp[c - 1])))

    def _round(self, fn):
        def wrapped(g, vols=None):
            slot = self.rounds.slot() if self.window else None
            if slot is None:
                return fn(g, vols)
            st = self.droid.video.state
            act = np.nonzero(g.active)[0]
            a = torch.as_tensor(act, device=g.target.device)
            pre = dict(ii=g.ii.copy(), jj=g.jj.copy(),
                       active=g.active.copy(), inac=g.inac.copy(),
                       target=g.target.clone(), weight=g.weight.clone(),
                       net=g.net[a].clone(), poses=st.poses.clone(),
                       disps=st.disps.clone(), damping=st.damping.clone(),
                       disps_sens=st.disps_sens.clone(),
                       intrinsics=st.intrinsics.clone(),
                       tstamp=st.tstamp.clone())
            g = fn(g, vols)
            post = dict(target=g.target.clone(), weight=g.weight.clone(),
                        damping=st.damping.clone(), poses=st.poses.clone(),
                        disps=st.disps.clone())
            self.rounds.items[slot] = (pre, post)
            return g
        return wrapped

    def lookup_recorder(self, corr_ops):
        """Record every serving-lookup launch's coordinates and planes (the
        traced run only); returns a function that undoes it."""
        orig = corr_ops.lookup_pyramid_flat

        def rec(vols, coords, *a, **k):
            if self.window:
                self.lookups.append((coords, [tuple(v.shape[2:])
                                              for v in vols],
                                     vols[0].element_size()))
            return orig(vols, coords, *a, **k)

        corr_ops.lookup_pyramid_flat = rec
        return lambda: setattr(corr_ops, "lookup_pyramid_flat", orig)


def run(ctx):
    dev = ctx.device
    cfg = slam_config(ctx.config)
    tp, wl = ctx.traffic, ctx.workload
    H, W = cfg.image_size
    rng = np.random.default_rng([ctx.seed, 1])

    data = loader.generator(tp["generator"]).make(tp, H, W, ctx.seed, dev)
    frames = data["images"].cpu().numpy()
    intr = data["intrinsics"]
    del data
    reset_peak(dev)

    from droid_slam_tpu_torch.ops import corr as corr_ops
    from droid_slam_tpu_torch.runtime.slam import Droid

    droid = Droid(cfg, weights_path=os.path.join(loader.ROOT,
                                                 ctx.config["weights"]),
                  device=dev)
    droid.prewarm()
    warm_update(droid, cfg)
    n0 = tp["setup_frames"]
    for t in range(n0):
        droid.track(float(t), frames[t], intrinsics=intr)
    sync(dev)
    probe = Probe(droid, ctx.seed, wl["sample"], ctx.trace)
    undo = probe.lookup_recorder(corr_ops) if ctx.trace else None

    lat, kfs, failed = [], [], 0
    devtrace = DeviceTrace(dev) if ctx.trace else None
    if devtrace:
        devtrace.start()
    probe.window = probe.spans.on = True
    t_start = now_ns()
    t_end = t_start
    deadline = t_start + int(ctx.seconds * 1e9)
    t = n0
    while t < len(frames) and t_end < deadline:
        probe.before_frame(t)
        t_in = now_ns()
        try:
            kf = droid.track(float(t), frames[t], intrinsics=intr)
            sync(dev)
        except RuntimeError as e:          # a frame the program refused
            failed += 1
            ctx.log(f"track failed at frame {t}: {e}")
            break
        t_end = now_ns()
        probe.spans.add("track.keyframe" if kf else "track.gate", t_in,
                        t_end)
        lat.append((t_end - t_in) / 1e6)
        kfs.append(bool(kf))
        t += 1
    probe.window = probe.spans.on = False
    rec = dict(setup_s=(t_start - ctx.t0_ns) / 1e9,
               window_s=(t_end - t_start) / 1e9, latency_ms=lat,
               keyframe=kfs, attempted=len(lat) + failed, failed=failed,
               frames_left=len(frames) - t)
    if devtrace:
        devtrace.stop()
        undo()
        t_read = now_ns()
        events, win = devtrace.events()
        rec["trace"] = summarize(events, win, probe.spans)
        rec["trace_read_s"] = (now_ns() - t_read) / 1e9
        rec["model_flops"] = probe.flops
        rec["lookup_bytes"] = sum(costs.pyramid_bytes(c, p, e)
                                  for c, p, e in probe.lookups)
        rec["lookup_launches"] = len(probe.lookups)
        rec["peak_flops"] = (costs.PEAK_BF16_FLOPS
                             if cfg.compute_dtype == "bfloat16"
                             else costs.PEAK_F32_FLOPS)
    rec["memory_peak_bytes"] = memory_peak(dev)

    st, count = droid.video.state, droid.video.counter
    slots = np.sort(rng.choice(count, min(wl["sample"]["keyframes"], count),
                               replace=False))
    s = torch.as_tensor(slots, device=dev)
    rec["encoded"] = dict(tstamp=st.tstamp[s].cpu().numpy(),
                          fmaps=st.fmaps[s, 0].clone(),
                          nets=st.nets[s].clone(), inps=st.inps[s].clone())
    rec["keyframes"] = count
    rec["gates"] = [g for g in probe.gates.items if g is not None]
    rec["rounds"] = [r for r in probe.rounds.items if r is not None]
    rec["window_rounds"] = probe.rounds.seen
    rec["frames"] = frames
    del droid, probe, st
    gc.collect()
    free(dev)
    return rec


def check(ctx, rec):
    """The compared numbers: the program (or, under `ctx.control`, the
    reference in the precision below the configuration's) against the
    reference, at the samples the window kept."""
    with precision.tf32(False):
        return _check(ctx, rec)


# The round's end gap follows the step the BA takes (about 1% of it) down
# to a floor that does not (the operator's rounding, about 5e-4 px): a
# step under a few tenths of a pixel counts as this much
END_STEP_FLOOR_PX = 0.2


def px_gap(pre, got, want):
    """Mean distance (px) between where `got`'s poses and disparities and
    `want`'s reproject the pixels of the edges `want`'s BA solved over,
    at the pixels valid under `want`."""
    c1, _ = ref.reprojection(pre, got["poses"], got["disps"], want["edges"])
    c0, valid = ref.reprojection(pre, want["poses"], want["disps"],
                                 want["edges"])
    return float((c1 - c0).norm(dim=-1)[valid].mean())


def _check(ctx, rec):
    dev = ctx.device
    conf = ctx.config
    limits = ctx.workload["limits"]
    net = load_net(os.path.join(loader.ROOT, conf["weights"]), dev).eval()
    net.requires_grad_(False)
    low = None
    if ctx.control:
        low = copy.deepcopy(net)
        precision.to_float8(low)
    images = torch.from_numpy(rec["frames"])
    out = []

    enc = rec["encoded"]
    stamps = torch.as_tensor(enc["tstamp"].round().astype(np.int64))
    want = ref.encode(net, images[stamps].to(dev))
    got = (ref.encode(low, images[stamps].to(dev)) if low is not None else
           (enc["fmaps"], enc["nets"], enc["inps"]))
    gaps = [max(rel_gap(got[i][k], want[i][k]) for k in range(len(stamps)))
            for i in range(3)]
    out.append(compared("encoder_gap", max(gaps), limits))

    gate = 0.0
    for g in rec["gates"]:
        fr, kf = images[g["frame"]].to(dev), images[g["keyframe"]].to(dev)
        d_ref = ref.gate_flow(net, fr, kf)
        d = ref.gate_flow(low, fr, kf) if low is not None else g["delta"]
        gate = max(gate, rel_gap(d, d_ref))
        ctx.log(f"gate frame {g['frame']} keyframe {g['keyframe']}: "
                f"flow {float(d.norm(dim=-1).mean())!r} reference "
                f"{float(d_ref.norm(dim=-1).mean())!r} gap "
                f"{rel_gap(d, d_ref)!r}")
    out.append(compared("gate_gap", gate, limits))

    # a round from the program's state before it: the update operator's
    # targets, weights and damping against the reference's, and the
    # round's end (the dense BA over the operator's outputs) against the
    # reference's operator followed by its BA in float64, compared where
    # the end state reprojects each BA edge's pixels (which the monocular
    # scale gauge leaves alone), over the reference's step there; each
    # number is the worst round
    flow = weight = damp = end_gap = 0.0
    slam = ctx.config["slam"]
    for pre, post in rec["rounds"]:
        act = np.nonzero(pre["active"])[0]
        a = torch.as_tensor(act, device=dev)
        fr = torch.as_tensor(np.unique(pre["ii"][act]), device=dev)
        want = ref.update_operator(net, pre, images)
        got = (ref.update_operator(low, pre, images) if low is not None
               else (post["target"], post["weight"], post["damping"]))
        f = float((got[0][a] - want[0][a]).abs().mean())
        wg = float((got[1][a].float() - want[1][a]).abs().mean())
        dg = rel_gap(got[2][fr], want[2][fr])
        chain = ref.dense_ba(slam, pre, *want)
        end = post
        if low is not None:
            with precision.tf32(True), precision.tf32_products():
                end = ref.dense_ba(slam, pre, *got, dtype=torch.float32)
        e, step = px_gap(pre, end, chain), px_gap(pre, pre, chain)
        flow, weight, damp = max(flow, f), max(weight, wg), max(damp, dg)
        end_gap = max(end_gap, e / (step + END_STEP_FLOOR_PX))
        t0, t1 = chain["window"]
        ctx.log(f"round at frames {t0}..{t1} ({len(a)} edges): targets "
                f"{f!r} px, weights {wg!r}, damping {dg!r}; end {e!r} px "
                f"of a step of {step!r}")
    out.append(compared("round_flow_px", flow, limits))
    out.append(compared("round_weight_gap", weight, limits))
    out.append(compared("round_damping_gap", damp, limits))
    out.append(compared("round_end_gap", end_gap, limits))
    n = dict(gates=len(rec["gates"]), rounds=len(rec["rounds"]),
             keyframes=len(stamps))
    return out, n
