"""Plain reference of the first optimizer steps of training: the
unrolled forward (the reference DroidNet, plain lookups), the losses,
autograd, global-norm clipping and AdamW at the one-cycle learning rate.

It follows the program's draws: each step's batch (the benchmark's own
data), the frame graph the trainer drew for it and the number of
random-restart passes it ran.  Its restarts carry its own estimates.
"""

import math

import numpy as np
import torch

from . import losses, se3

WEIGHT_DECAY = 1e-5
LOSS_WEIGHTS = (10.0, 0.01, 0.05)


def onecycle_lr(step, total_steps, peak, pct_start=0.01, div_factor=25.0,
                final_div_factor=1e4):
    init = peak / div_factor
    final = init / final_div_factor
    up = int(pct_start * total_steps)

    def cosine(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    if step < up:
        return cosine(init, peak, step / up)
    if step < total_steps:
        return cosine(peak, final, (step - up) / (total_steps - up))
    return final


def make_batch(sample, ii, jj, cap, device):
    """A numpy sample (images, poses c2w, disps, intrinsics) and its graph
    padded to `cap` edge slots, as tensors."""
    n = len(ii)
    ii_p = np.zeros(cap, np.int64)
    jj_p = np.zeros(cap, np.int64)
    mask = np.zeros(cap, bool)
    ii_p[:n], jj_p[:n], mask[:n] = ii, jj, True
    disps = sample["disps"]
    h8, w8 = disps.shape[2] // 8, disps.shape[3] // 8

    def t(x, dtype=torch.float32):
        return torch.as_tensor(np.ascontiguousarray(x), dtype=dtype,
                               device=device)

    return dict(images=t(sample["images"]), poses=t(sample["poses"]),
                disps=t(disps[:, :, 3::8, 3::8][:, :, :h8, :w8]),
                disps_full=t(disps), intrinsics=t(sample["intrinsics"]),
                ii=t(ii_p, torch.long), jj=t(jj_p, torch.long),
                edge_mask=t(mask, torch.bool))


def loss_fn(net, batch, Gs0, disp0, iters, fix_scale):
    Ps = se3.inv(batch["poses"])
    N = Ps.shape[1]
    Gs_default = torch.cat([Ps[:, :1], Ps[:, 1:2].expand(-1, N - 1, -1)],
                           dim=1)
    use_restart = (disp0 > 0).any()
    Gs = torch.where(use_restart, Gs0, Gs_default)
    d0 = torch.where(use_restart, disp0, torch.ones_like(batch["disps"]))
    ii, jj, emask = batch["ii"], batch["jj"], batch["edge_mask"]
    poses_est, disps_est, residuals = net(
        Gs, batch["images"], d0, batch["intrinsics"] / 8.0, ii, jj,
        num_steps=iters, fixedp=2, edge_mask=emask)
    geo, _ = losses.geodesic_loss(Ps, poses_est, ii, jj,
                                  do_scale=not fix_scale, edge_mask=emask)
    res, _ = losses.residual_loss(residuals, edge_mask=emask)
    flo, _ = losses.flow_loss(Ps, batch["disps_full"], poses_est, disps_est,
                              batch["intrinsics"])
    w1, w2, w3 = LOSS_WEIGHTS
    loss = w1 * geo + w2 * res + w3 * flo
    return (loss, poses_est[-1].detach(),
            disps_est[-1][:, :, 3::8, 3::8].detach())


def run_steps(net, cfg, steps):
    """`steps`: list of dict(batch, passes).  Returns dict(losses: one
    list per step, grad1: the first step's clipped gradient by parameter
    name, delta: each parameter's change over the steps)."""
    params = dict(net.named_parameters())
    start = {k: p.detach().clone() for k, p in params.items()}
    opt = torch.optim.AdamW(net.parameters(), lr=cfg["lr"],
                            betas=(0.9, 0.999), eps=1e-8,
                            weight_decay=WEIGHT_DECAY)
    out = dict(losses=[], grad1=None)
    for s, step in enumerate(steps):
        batch = step["batch"]
        B, N = batch["images"].shape[:2]
        h8, w8 = batch["disps"].shape[-2:]
        dev = batch["images"].device
        Gs0 = torch.zeros((B, N, 7), device=dev)
        disp0 = torch.zeros((B, N, h8, w8), device=dev)
        acc = {k: torch.zeros_like(p) for k, p in params.items()}
        step_losses = []
        for _ in range(step["passes"]):
            loss, Gs0, disp0 = loss_fn(net, batch, Gs0, disp0, cfg["iters"],
                                       cfg["fix_scale"])
            grads = torch.autograd.grad(loss, list(params.values()),
                                        allow_unused=True)
            for (k, p), g in zip(params.items(), grads):
                if g is not None:
                    acc[k] += torch.where(torch.isfinite(g), g,
                                          torch.zeros_like(g))
            step_losses.append(float(loss.detach()))
        out["losses"].append(step_losses)
        clean = {k: torch.where(torch.isnan(g), torch.zeros_like(g), g)
                 for k, g in acc.items()}
        g_norm = torch.sqrt(sum((g ** 2).sum() for g in clean.values()))
        scale = torch.where(g_norm < cfg["clip"], torch.ones_like(g_norm),
                            cfg["clip"] / g_norm)
        for k, p in params.items():
            p.grad = clean[k] * scale
        if s == 0:
            out["grad1"] = {k: p.grad.detach().clone()
                            for k, p in params.items()}
        lr = onecycle_lr(s, cfg["steps"], cfg["lr"])
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        opt.zero_grad(set_to_none=True)
    out["delta"] = {k: p.detach() - start[k] for k, p in params.items()}
    return out
