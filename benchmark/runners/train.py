"""Training cells: `droid_slam_tpu_torch.training.trainer.train`, the loop
the port's train.py runs, over a dataset object the benchmark hands it.

Set-up renders the scenes on the device, then one call of `train`
builds the train state (warm-started from the configuration's weights),
draws batches, graphs and restarts itself, and takes its first three
optimizer steps: those are set-up, and the check follows them.  The
window opens when the trainer asks for its fourth batch (after a
synchronize) and closes at the first request after `--seconds`; the
dataset then ends the call.  Every accumulate pass the trainer completed
in between counts.

The benchmark records, around the calls into the train step (wrapped as
`train` builds them), each pass's loss and graph in set-up, the
optimizer's state after the first step and the parameters after the
third.
"""

import dataclasses
import gc
import os
import shutil
import sys
import tempfile

import numpy as np
import torch

from benchmark.runners.common import (compared, free, memory_peak, now_ns,
                                      reset_peak, sync)
from benchmark.lib import costs, loader
from benchmark.lib.spans import Spans
from benchmark.lib.trace import DeviceTrace, summarize
from benchmark.reference import precision
from benchmark.reference import training as ref
from benchmark.reference.weights import load_net

SETUP_STEPS = 3


class WindowClosed(Exception):
    """Raised by the dataset to end `train` at the window's close."""


class Recorder:
    """The dataset the trainer reads, and the wrappers of its train step:
    opens and closes the window, counts passes, keeps what the check
    needs from the set-up steps."""

    def __init__(self, scenes, ctx, trace):
        self.scenes = scenes
        self.ctx = ctx
        self.trace = trace
        self.spans = Spans()
        self.samples = []               # the set-up steps' batches
        self.passes = [[]]              # per step: (loss, ii, jj)
        self.steps = 0
        self.window_passes = 0
        self.window = False
        self.t_start = self.t_end = None
        self.state = None
        self.start_params = None
        self.grad1 = None
        self.after = None
        self.flops = 0
        self.lookups = []

    def __len__(self):
        return len(self.scenes)

    def sample_batches(self, batch_size, rng):
        inner = self.scenes.sample_batches(batch_size, rng)
        dev = self.ctx.device
        while True:
            n = self.steps
            if n == SETUP_STEPS:
                sync(dev)
                if self.trace:
                    self.trace.start()
                self.t_start = now_ns()
                self.window = self.spans.on = True
            elif n > SETUP_STEPS and now_ns() - self.t_start >= int(
                    self.ctx.seconds * 1e9):
                sync(dev)
                self.t_end = now_ns()
                self.window = self.spans.on = False
                if self.trace:
                    self.trace.stop()
                raise WindowClosed
            t0 = now_ns()
            batch = next(inner)
            self.spans.add("draw", t0, now_ns())
            if n < SETUP_STEPS:
                self.samples.append(batch)
            yield batch

    def create_state(self, fn):
        def wrapped(*a, **k):
            self.state = fn(*a, **k)
            return self.state
        return wrapped

    def make_step(self, fn):
        def wrapped(*a, **k):
            accum, apply = fn(*a, **k)
            return (self.spans.wrap("pass", self._accum(accum)),
                    self.spans.wrap("apply", self._apply(apply)))
        return wrapped

    def _accum(self, accum):
        def wrapped(acc, net, batch, Gs0, disp0):
            if self.start_params is None:
                self.start_params = {k: p.detach().clone()
                                     for k, p in net.named_parameters()}
            if self.window and self.ctx.trace:
                self._count_flops(batch)
            acc, metrics = accum(acc, net, batch, Gs0, disp0)
            if self.steps < SETUP_STEPS:
                m = batch["edge_mask"]
                self.passes[-1].append((metrics["loss"].clone(),
                                        batch["ii"][m].cpu().numpy(),
                                        batch["jj"][m].cpu().numpy()))
            self.window_passes += self.window
            return acc, metrics
        return wrapped

    def _apply(self, apply):
        def wrapped(state, grads):
            out = apply(state, grads)
            self.steps += 1
            params = dict(state.net.named_parameters())
            if self.steps == 1:
                b1 = state.opt.param_groups[0]["betas"][0]
                self.grad1 = {k: state.opt.state[p]["exp_avg"] / (1.0 - b1)
                              for k, p in params.items()}
            if self.steps == SETUP_STEPS:
                self.after = {k: p.detach().clone()
                              for k, p in params.items()}
            if self.steps < SETUP_STEPS:
                self.passes.append([])
            return out
        return wrapped

    def _count_flops(self, batch):
        B, N, H, W = batch["images"].shape[:4]
        h, w = H // 8, W // 8
        E = int(batch["edge_mask"].sum())
        iters = self.ctx.config["train"]["iters"]
        fwd = (B * N * (costs.encoder_flops(H, W, 128)
                        + costs.encoder_flops(H, W, 256))
               + B * costs.volume_flops(E, h, w)
               + iters * (costs.update_flops(B * E, h, w, B * N, True)
                          + costs.upsample_flops(B * N, h, w)))
        self.flops += 3 * fwd

    def lookup_recorder(self, corr_ops):
        """Record each training lookup's coordinates and pyramid planes
        (the traced run only); returns a function that undoes it."""
        orig = corr_ops.lookup_pyramid

        def rec(pyramid, coords, *a, **k):
            if self.window:
                self.lookups.append((coords.detach(),
                                     [tuple(v.shape[-2:]) for v in pyramid],
                                     pyramid[0].element_size()))
            return orig(pyramid, coords, *a, **k)

        corr_ops.lookup_pyramid = rec
        return lambda: setattr(corr_ops, "lookup_pyramid", orig)


def train_config(conf, tmp):
    from droid_slam_tpu_torch.config import TrainConfig

    fields = {k: tuple(v) if isinstance(v, list) else v
              for k, v in conf["train"].items()}
    return dataclasses.replace(TrainConfig(**fields),
                               ckpt_dir=os.path.join(tmp, "checkpoints"))


def run(ctx):
    dev = ctx.device
    tmp = tempfile.mkdtemp(prefix="droid_bench_train_")
    try:
        return _run(ctx, dev, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _run(ctx, dev, tmp):
    cfg = train_config(ctx.config, tmp)
    H, W = cfg.image_size
    scenes = loader.generator(ctx.traffic["generator"]).make(
        ctx.traffic, H, W, ctx.seed, dev, cfg.n_frames)
    reset_peak(dev)

    from droid_slam_tpu_torch.ops import corr as corr_ops
    from droid_slam_tpu_torch.training import trainer

    # the trainer's logger writes TensorBoard scalars where TensorBoard
    # imports; where TensorFlow is installed that import loads JAX, so the
    # run keeps it out (the logger then writes its JSONL file alone)
    sys.modules.setdefault("torch.utils.tensorboard", None)
    devtrace = DeviceTrace(dev) if ctx.trace else None
    rec = Recorder(scenes, ctx, devtrace)
    patched = dict(create_train_state=rec.create_state(
        trainer.create_train_state),
        make_train_step=rec.make_step(trainer.make_train_step))
    orig = {k: getattr(trainer, k) for k in patched}
    undo = rec.lookup_recorder(corr_ops) if ctx.trace else None
    for k, v in patched.items():
        setattr(trainer, k, v)
    try:
        trainer.train(cfg, rec, device=dev, seed=ctx.seed,
                      init_npz=os.path.join(loader.ROOT,
                                            ctx.config["weights"]),
                      log_dir=os.path.join(tmp, "runs"),
                      lookup_impl=ctx.config["lookup_impl"])
        raise RuntimeError("train returned before the window closed")
    except WindowClosed:
        pass
    finally:
        for k, v in orig.items():
            setattr(trainer, k, v)
        if undo:
            undo()
    out = dict(setup_s=(rec.t_start - ctx.t0_ns) / 1e9,
               window_s=(rec.t_end - rec.t_start) / 1e9,
               passes=rec.window_passes, attempted=rec.window_passes,
               failed=0, steps=rec.steps - SETUP_STEPS)
    if devtrace:
        t_read = now_ns()
        events, win = devtrace.events()
        out["trace"] = summarize(events, win, rec.spans)
        out["trace_read_s"] = (now_ns() - t_read) / 1e9
        out["model_flops"] = rec.flops
        out["peak_flops"] = costs.PEAK_F32_FLOPS
        # forward and gradient read or write the same window elements
        out["lookup_bytes"] = 2 * sum(costs.pyramid_bytes(c, p, e)
                                      for c, p, e in rec.lookups)
        out["lookup_launches"] = len(rec.lookups)
    out["memory_peak_bytes"] = memory_peak(dev)
    out["samples"] = rec.samples
    out["program"] = dict(
        losses=[[float(l) for l, _, _ in step] for step in rec.passes],
        graphs=[(step[0][1], step[0][2]) for step in rec.passes],
        grad1={k: v.detach().clone() for k, v in rec.grad1.items()},
        delta={k: rec.after[k] - rec.start_params[k] for k in rec.after})
    out["edge_cap"] = trainer.edge_capacity(cfg)
    del rec, scenes
    gc.collect()
    free(dev)
    return out


def _leaf_gaps(got, want, keep=None):
    """The worst leaf's gap of norms: |‖got‖ − ‖want‖| over the larger of
    ‖want‖ and the median leaf's ‖want‖, over the leaves in `keep`."""
    names = sorted(want if keep is None else keep)
    gn = {k: float(got[k].float().norm()) for k in names}
    wn = {k: float(want[k].float().norm()) for k in names}
    med = float(np.median(list(wn.values())))
    return max(abs(gn[k] - wn[k]) / max(wn[k], med) for k in names)


def _perturbed(batch, step):
    """The batch with its images moved by `step` grey levels."""
    return dict(batch, images=batch["images"] + step)


def check(ctx, rec):
    """The compared numbers over the three set-up steps: the first step's
    gradient and the change of the parameters after the three, the
    program's (or, under `ctx.control`, the TF32 reference's) against the
    float32 reference's, each by its worst leaf.

    The unrolled BA makes these steps sensitive to rounding: two float32
    orders of summation part the gradient by up to a few percent on some
    samples.  So each gap is divided by the reference's own: the
    reference runs a second time with every image moved by
    `repeat_step` grey levels, a change far below the images' rounding,
    and its gap to the first run is the yardstick.  Each pass's loss is
    logged beside it, not compared (PERF.md)."""
    dev = ctx.device
    conf = ctx.config
    wl = ctx.workload
    limits = wl["limits"]
    cfg = dict(conf["train"])
    prog = rec["program"]
    steps = [dict(batch=ref.make_batch(s, g[0], g[1], rec["edge_cap"], dev),
                  passes=len(l))
             for s, g, l in zip(rec["samples"], prog["graphs"],
                                prog["losses"])]
    moved = [dict(s, batch=_perturbed(s["batch"], wl["repeat_step"]))
             for s in steps]
    weights = os.path.join(loader.ROOT, conf["weights"])
    with precision.tf32(False):
        want = ref.run_steps(load_net(weights, dev), cfg, steps)
        again = ref.run_steps(load_net(weights, dev), cfg, moved)
    if ctx.control:
        with precision.tf32(True):
            got = ref.run_steps(load_net(weights, dev), cfg, steps)
    else:
        got = dict(losses=prog["losses"], grad1=prog["grad1"],
                   delta=prog["delta"])
    for k, (ga, wa, aa) in enumerate(zip(got["losses"], want["losses"],
                                         again["losses"])):
        for j, (a, b, c) in enumerate(zip(ga, wa, aa)):
            ctx.log(f"step {k + 1} pass {j + 1}: loss {a!r} reference {b!r}"
                    f" repeat {c!r}")
    gnorm = {k: float(v.norm()) for k, v in want["grad1"].items()}
    med = float(np.median(list(gnorm.values())))
    moving = [k for k, v in gnorm.items() if v >= 1e-3 * med]
    grad = _leaf_gaps(got["grad1"], want["grad1"])
    grad_rep = _leaf_gaps(again["grad1"], want["grad1"])
    change = _leaf_gaps(got["delta"], want["delta"], moving)
    change_rep = _leaf_gaps(again["delta"], want["delta"], moving)
    ctx.log(f"gradient gap {grad!r}, repeat {grad_rep!r}; change gap "
            f"{change!r}, repeat {change_rep!r}")
    out = [compared("grad_gap_ratio", grad / max(grad_rep, 1e-12), limits),
           compared("update_gap_ratio", change / max(change_rep, 1e-12),
                    limits)]
    n = dict(steps=len(steps), passes=sum(len(l) for l in prog["losses"]),
             leaves=len(gnorm), leaves_moving=len(moving))
    return out, n
