"""The training step: unrolled DroidNet forward with two differentiable BA
solves per iteration, γ-discounted geodesic + residual + flow losses,
global-norm gradient clipping, AdamW with a one-cycle schedule.

The step is split in two so that random-restart chains can accumulate
gradients across passes and step the optimizer once: `accum` runs one
forward/backward and adds its gradients into a running sum, `apply` clips
the sum and updates the parameters.

Under a process group each rank accumulates over its slice of the global
batch, and `all_reduce_gradients` sums the ranks' gradients (and
averages the metrics) once, between the last `accum` and `apply`.  The
loss is a mean over the batch, and each rank differentiates its slice's
mean divided by the world size: every element's gradient is then the one
the whole batch gives it in one process.  That matters beyond a constant
factor because `grad_clip` (models/layers.py) zeroes gradient elements
above a fixed magnitude on the way back, so summing or averaging
gradients taken at another scale would clip other elements.
"""

import dataclasses
import math
import warnings

import numpy as np
import torch

from ..geom import losses
from ..lie import se3
from ..models.droidnet import DroidNet, random_init
from ..parallel.launch import world_size
from ..runtime.slam import resolve_device

WEIGHT_DECAY = 1e-5


def onecycle_lr(step, total_steps, peak, pct_start=0.01, div_factor=25.0,
                final_div_factor=1e4):
    """Learning rate of optax.cosine_onecycle_schedule(total_steps, peak,
    pct_start) at `step`: cosine from peak/div_factor up to peak over the
    first int(pct_start·total_steps) steps, then cosine down to
    peak/(div_factor·final_div_factor) at total_steps, constant after.
    A warm-up of zero steps (total_steps < 1/pct_start) is skipped."""
    if total_steps <= 0:
        raise ValueError("onecycle_lr needs a positive total_steps")
    init = peak / div_factor
    final = init / final_div_factor
    up = int(pct_start * total_steps)
    total = int(total_steps)

    def cosine(start, end, pct):
        return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)

    if step < up:
        return cosine(init, peak, step / up)
    if step < total:
        return cosine(peak, final, (step - up) / (total - up))
    return final


@dataclasses.dataclass
class TrainState:
    """Everything a resumed run needs: the network, its optimizer and the
    number of optimizer steps taken."""
    net: DroidNet
    opt: torch.optim.Optimizer
    step: int
    cfg: object

    def params(self):
        return dict(self.net.named_parameters())


def make_optimizer(net, cfg):
    """AdamW (weight decay 1e-5); `apply` sets the learning rate of each
    step from `onecycle_lr` and clips by global norm first."""
    return torch.optim.AdamW(net.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                             eps=1e-8, weight_decay=WEIGHT_DECAY)


def create_train_state(cfg, seed=0, device=None):
    """A float32 DroidNet with seeded random weights on `device` (the CUDA
    card unless `device="cpu"` is passed), and a fresh optimizer."""
    net = random_init(DroidNet(), seed).float().to(resolve_device(device))
    return TrainState(net=net, opt=make_optimizer(net, cfg), step=0, cfg=cfg)


def pad_edges(ii, jj, cap):
    """Pad an edge list to a fixed capacity with a validity mask."""
    ii = np.asarray(ii).reshape(-1)
    jj = np.asarray(jj).reshape(-1)
    n = len(ii)
    if n > cap:
        warnings.warn(
            f"pad_edges: truncating {n} edges to capacity {cap}; later "
            f"frames lose BA constraints — raise edge_cap", stacklevel=2)
        ii, jj, n = ii[:cap], jj[:cap], cap
    ii_p = np.zeros(cap, np.int64)
    jj_p = np.zeros(cap, np.int64)
    mask = np.zeros(cap, bool)
    ii_p[:n], jj_p[:n], mask[:n] = ii, jj, True
    return ii_p, jj_p, mask


def zero_grads(net):
    """A zeroed gradient sum, keyed like `net.named_parameters()`."""
    return {k: torch.zeros_like(p) for k, p in net.named_parameters()}


def all_reduce_gradients(grads, metrics):
    """Sum the ranks' gradient sums and average their scalar metrics over
    the default process group, in one all-reduce of one flat buffer;
    returns them unchanged in a single process.  Every rank then clips
    and steps on the same gradient, the whole batch's."""
    import torch.distributed as dist

    world = world_size()
    if world == 1:
        return grads, metrics
    dev = next(iter(grads.values())).device
    parts = [g.reshape(-1) for g in grads.values()] + [
        torch.as_tensor(v, dtype=torch.float32, device=dev).reshape(1)
        / world for v in metrics.values()]
    flat = torch.cat(parts)
    dist.all_reduce(flat)
    out = list(flat.split([p.numel() for p in parts]))
    grads = {k: out.pop(0).reshape(g.shape) for k, g in grads.items()}
    metrics = {k: out.pop(0)[0] for k in metrics}
    return grads, metrics


def global_norm(tensors):
    return torch.sqrt(sum((t.float() ** 2).sum() for t in tensors))


def make_train_step(*, iters=15, fix_scale=True, w1=10.0, w2=0.01, w3=0.05,
                    remat=False):
    """Build the (accum, apply) pair.

    batch: dict(images (B,N,H,W,3), poses (B,N,7) c2w ground truth,
                disps (B,N,h,w) ground-truth inverse depth at 1/8,
                disps_full (B,N,H,W) at full resolution,
                intrinsics (B,N,4) full-res,
                ii/jj (E,) long, edge_mask (E,) bool), tensors on the
    network's device.
    """

    def loss_fn(net, batch, Gs0, disp0):
        # dataset poses are c2w; the pipeline optimizes w2c
        Ps = se3.inv(batch["poses"])
        N = Ps.shape[1]

        # pose init: frame 0 at ground truth, all others at frame 1's
        # pose — or the previous attempt's estimates on a random restart
        Gs_default = torch.cat([Ps[:, :1], Ps[:, 1:2].expand(-1, N - 1, -1)],
                               dim=1)
        use_restart = (disp0 > 0).any()
        Gs = torch.where(use_restart, Gs0, Gs_default)
        d0 = torch.where(use_restart, disp0, torch.ones_like(batch["disps"]))
        intr8 = batch["intrinsics"] / 8.0
        ii, jj = batch["ii"], batch["jj"]
        emask = batch["edge_mask"]

        poses_est, disps_est, residuals = net(
            Gs, batch["images"], d0, intr8, ii, jj, num_steps=iters,
            fixedp=2, edge_mask=emask, remat=remat)

        geo, geo_m = losses.geodesic_loss(Ps, poses_est, ii, jj,
                                          do_scale=not fix_scale,
                                          edge_mask=emask)
        res, res_m = losses.residual_loss(residuals, edge_mask=emask)
        flo, flo_m = losses.flow_loss(Ps, batch["disps_full"], poses_est,
                                      disps_est, batch["intrinsics"])
        loss = w1 * geo + w2 * res + w3 * flo
        metrics = dict(loss=loss, geo=geo, res=res, flow=flo,
                       **geo_m, **res_m, **flo_m)
        metrics = {k: v.detach() for k, v in metrics.items()}
        # carry the final estimates for random restarts
        metrics["_Gs_last"] = poses_est[-1].detach()
        metrics["_disp_last"] = disps_est[-1][:, :, 3::8, 3::8].detach()
        return loss, metrics

    def accum(acc, net, batch, Gs0, disp0):
        """One restart pass: its gradients added into the running sum
        `acc` (in place).  Non-finite gradient elements are zeroed BEFORE
        the sum — otherwise one NaN pass would poison the whole restart
        chain.  Under a process group the gradients are those of the
        slice's loss over the world size (see the module's docstring)."""
        loss, metrics = loss_fn(net, batch, Gs0, disp0)
        names, params = zip(*net.named_parameters())
        world = world_size()
        grads = torch.autograd.grad(loss / world if world > 1 else loss,
                                    params, allow_unused=True)
        bad = 0
        total = 0
        for name, p, g in zip(names, params, grads):
            total += p.numel()
            if g is None:
                continue
            finite = torch.isfinite(g)
            bad = bad + (~finite).sum()
            acc[name] += torch.where(finite, g, torch.zeros_like(g))
        metrics["grad_nonfinite_frac"] = torch.as_tensor(bad) / total
        return acc, metrics

    def apply(state, grads):
        """Clip the gradient sum by global norm and take one AdamW step at
        the schedule's learning rate for `state.step`."""
        cfg = state.cfg
        params = state.params()
        clean = {k: torch.where(torch.isnan(g), torch.zeros_like(g), g)
                 for k, g in grads.items()}
        g_norm = global_norm(clean.values())
        scale = torch.where(g_norm < cfg.clip, torch.ones_like(g_norm),
                            cfg.clip / g_norm)
        for k, p in params.items():
            p.grad = clean[k] * scale
        lr = onecycle_lr(state.step, cfg.steps, cfg.lr)
        for group in state.opt.param_groups:
            group["lr"] = lr
        state.opt.step()
        state.opt.zero_grad(set_to_none=True)
        state.step += 1
        with torch.no_grad():
            return {"param_norm": global_norm(params.values()),
                    "grad_norm": global_norm(grads.values())}

    return accum, apply
