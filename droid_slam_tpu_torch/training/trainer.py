"""The training loop.

Per-batch random graph choice (50% flow-covisibility graph, 50% temporal
|i−j| ≤ 2), first-two-pose anchoring, a random-restart inner loop that
reuses the last estimates, metrics logging, and periodic checkpoints of
the full train state (parameters, optimizer, step) with `torch.save`.

Data parallel under a process group (parallel/launch.py): every rank
draws the same global batches, graphs and restart decisions from the
same seeds and trains on its slice of each batch; the ranks' gradients
are summed into the whole batch's before every optimizer step, so all
ranks keep the same parameters.  Rank 0 alone logs and writes checkpoints.
"""

import os
import time

import numpy as np
import torch

from ..config import TrainConfig
from ..geom.graph_utils import build_frame_graph, temporal_graph
from ..models.convert import load_weights
from ..ops import corr as corr_ops
from ..parallel.launch import local_batch_slice, rank
from ..runtime.slam import resolve_device
from ..utils.timers import span, sync_site
from .logger import Logger
from .train_step import (all_reduce_gradients, create_train_state,
                         make_optimizer, make_train_step, pad_edges,
                         zero_grads)


def save_checkpoint(ckpt_dir, state, step):
    """Write the full train state; returns the file's path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.abspath(os.path.join(ckpt_dir, f"step_{step:06d}.pt"))
    torch.save({"model": state.net.state_dict(),
                "opt": state.opt.state_dict(), "step": int(state.step)},
               path)
    return path


def restore_checkpoint(path, state):
    """Load a checkpoint written by `save_checkpoint` into `state`."""
    dev = next(state.net.parameters()).device
    ckpt = torch.load(path, map_location=dev, weights_only=True)
    state.net.load_state_dict(ckpt["model"], strict=True)
    state.opt.load_state_dict(ckpt["opt"])
    state.step = int(ckpt["step"])
    return state


def edge_capacity(cfg):
    """Edge slots that hold BOTH graph families: the covisibility sampler
    emits about cfg.edges, the temporal |i-j| <= 2 graph 4N - 6; rounded
    up to a multiple of 8."""
    need = max(cfg.edges + 12, 4 * cfg.n_frames - 6)
    return int(np.ceil(need / 8) * 8)


def make_batch(batch_np, ii, jj, cap, device):
    """A sampled numpy batch and its graph as the train step's tensors."""
    ii_p, jj_p, emask = pad_edges(ii, jj, cap)
    disps = batch_np["disps"]
    h8, w8 = disps.shape[2] // 8, disps.shape[3] // 8

    def dev(x, dtype=torch.float32):
        with sync_site("h2d.batch"):
            return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                                   device=device)

    return dict(
        images=dev(batch_np["images"]), poses=dev(batch_np["poses"]),
        disps=dev(disps[:, :, 3::8, 3::8][:, :, :h8, :w8]),
        disps_full=dev(disps), intrinsics=dev(batch_np["intrinsics"]),
        ii=dev(ii_p, torch.long), jj=dev(jj_p, torch.long),
        edge_mask=dev(emask, torch.bool))


def train(cfg: TrainConfig, dataset, device=None, max_steps=None,
          log_every=10, seed=0, edge_cap=None, resume=None, init_npz=None,
          start_step=None, log_dir="runs", lookup_impl="level"):
    """Run training over `dataset` (any object with
    `sample_batches(batch_size, rng)` yielding numpy batches), in float32,
    on the CUDA card unless `device="cpu"` is passed.

    Edge lists are padded to a fixed capacity.  Random-restart chains
    accumulate gradients and step the optimizer once.  `resume` continues
    from a checkpoint; `init_npz` warm-starts the parameters from a
    weights file (an .npz, or the reference's droid.pth) with a fresh
    optimizer, `start_step` labelling
    how far the source run had come.  Under a process group,
    `cfg.batch` is the global batch and must divide by its size.
    Returns the final `TrainState`.
    """
    local = local_batch_slice(cfg.batch)
    lead = rank() == 0
    device = resolve_device(device)
    # full-f32 matmuls and convolutions (cuDNN would use TF32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    corr_ops.set_lookup_impl(lookup_impl)

    state = create_train_state(cfg, seed, device)
    if resume:
        restore_checkpoint(resume, state)
        print(f"resumed from {resume} at step {state.step}", flush=True)
    elif init_npz:
        load_weights(state.net, init_npz)
        state.opt = make_optimizer(state.net, cfg)
        state.step = int(start_step or 0)
        print(f"warm-started from {init_npz} at step {state.step} "
              f"(fresh optimizer)", flush=True)
    logger = Logger(cfg.name, log_dir) if lead else None

    # the data and graph randomness derive from (seed, resume step): a
    # resumed run continues the stream instead of replaying its batches
    start_step = state.step
    rng = np.random.default_rng([seed, start_step])
    max_steps = max_steps or cfg.steps
    N = cfg.n_frames
    cap = edge_cap or edge_capacity(cfg)

    # one sample's unrolled activations take about half of an 80 GB card
    # at the default sizes, so larger batches recompute each iteration in
    # the backward pass
    accum, apply_g = make_train_step(
        iters=cfg.iters, fix_scale=cfg.fix_scale,
        remat=local.stop - local.start > 1)
    batches = dataset.sample_batches(
        cfg.batch, rng=np.random.default_rng([seed + 1, start_step]))
    total_steps = start_step

    try:
        while total_steps < max_steps:
            with span("train.draw"):
                batch_np = next(batches)

            # randomize the frame graph per batch
            with span("train.graph"):
                if rng.random() < 0.5:
                    ii, jj = build_frame_graph(
                        batch_np["poses"], batch_np["disps"],
                        batch_np["intrinsics"], num=cfg.edges,
                        device=device)
                else:
                    ii, jj = temporal_graph(N, r=2)
            with span("train.batch"):
                batch = make_batch({k: v[local]
                                    for k, v in batch_np.items()},
                                   ii, jj, cap, device)

            t0 = time.perf_counter()
            B, N2 = batch["images"].shape[:2]
            h8, w8 = batch["disps"].shape[-2:]
            Gs0 = torch.zeros((B, N2, 7), device=device)
            # all-zero => default init
            disp0 = torch.zeros((B, N2, h8, w8), device=device)

            # random restarts reusing the last estimates, gradients
            # summed across the chain, ONE optimizer step
            grads = zero_grads(state.net)
            r = 0.0
            while r < cfg.restart_prob:
                r = rng.random()
                with span("train.pass"):
                    grads, metrics = accum(grads, state.net, batch, Gs0,
                                           disp0)
                Gs0 = metrics.pop("_Gs_last")
                disp0 = metrics.pop("_disp_last")

            with span("train.apply"):
                grads, metrics = all_reduce_gradients(grads, metrics)
                metrics.update(apply_g(state, grads))
            total_steps += 1
            if lead and (total_steps % log_every == 0 or total_steps == 1):
                with span("train.log"):
                    with sync_site("log.metrics", len(metrics)):
                        m = {k: float(v) for k, v in metrics.items()}
                    m["step_time"] = time.perf_counter() - t0
                    logger.push(m, total_steps)
                    nf = m.get("grad_nonfinite_frac", 0.0)
                    print(f"step {total_steps}: loss {m['loss']:.4f} "
                          f"geo {m['geo']:.4f} flow {m['flow']:.4f} "
                          f"pnorm {m['param_norm']:.1f} "
                          f"gnorm {m['grad_norm']:.2f} "
                          + (f"nanfrac {nf:.3f} " if nf > 0 else "")
                          + f"({m['step_time']:.2f}s)", flush=True)

            if lead and total_steps % cfg.ckpt_every == 0:
                save_checkpoint(cfg.ckpt_dir, state, total_steps)

        if lead:
            logger.flush(total_steps)
    finally:
        if lead:
            logger.close()
    final = os.path.join(cfg.ckpt_dir, f"step_{total_steps:06d}.pt")
    # ckpt_every may have just written it
    if lead and not os.path.exists(final):
        save_checkpoint(cfg.ckpt_dir, state, total_steps)
    return state
