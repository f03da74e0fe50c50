"""DroidNet: feature/context encoders, update operator, and the training
forward (unrolled updates with differentiable BA).

Images are RGB in [0, 255]; ImageNet normalization is applied here.
"""

import math

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import ba as geom_ba
from . import projective
from . import corr as corr_ops
from .extractor import BasicEncoder
from .update import UpdateModule, upsample_disp

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images):
    """(..., H, W, 3) RGB in [0,255] -> ImageNet-normalized float32."""
    x = images.float() / 255.0
    mean = x.new_tensor(IMAGENET_MEAN)
    std = x.new_tensor(IMAGENET_STD)
    return (x - mean) / std


def random_init(net, seed):
    """Deterministic random weights: conv kernels ~ N(0, 2/fan_out),
    biases 0 (the JAX package's initializer family), from an explicit
    generator."""
    g = torch.Generator().manual_seed(seed)
    for m in net.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.out_channels * m.kernel_size[0] * m.kernel_size[1]
            with torch.no_grad():
                m.weight.copy_(torch.randn(m.weight.shape, generator=g)
                               * math.sqrt(2.0 / fan_out))
                m.bias.zero_()
    return net


class DroidNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(output_dim=128, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=256, norm_fn="none")
        self.update = UpdateModule()

    def context(self, x):
        """Normalized images (..., H, W, 3) -> (net, inp) = (tanh, relu)
        halves of the context features, (..., h, w, 128) each."""
        ctx = self.cnet(x)
        net, inp = ctx.split(128, dim=-1)
        return torch.tanh(net), torch.relu(inp)

    def extract_features(self, images):
        """images: (B, N, H, W, 3) RGB uint8/float -> fmaps (B,N,h,w,128),
        net (tanh) and inp (relu) (B,N,h,w,128), h = H/8."""
        x = normalize_images(images)
        return (self.fnet(x),) + self.context(x)

    def forward(self, Gs, images, disps, intrinsics, ii, jj, num_steps=12,
                fixedp=2, edge_mask=None, remat=False):
        """Training forward: `num_steps` update iterations, each the
        correlation lookup, the update operator and two damped
        Gauss-Newton BA steps, with poses, disparities and coordinates
        detached between iterations (the GRU state backpropagates through
        the whole chain).

        Args:
          Gs: (B, N, 7) initial poses (w2c).
          images: (B, N, H, W, 3) RGB.
          disps: (B, N, H/8, W/8) initial inverse depths.
          intrinsics: (B, N, 4) at 1/8 resolution.
          ii, jj: (E,) long edge lists, padded to a fixed capacity.
          edge_mask: optional (E,) bool validity of the edge slots.
          remat: recompute each iteration in the backward pass instead of
            keeping its activations (less memory, one more forward).

        Returns stacked per-iteration poses (S, B, N, 7), upsampled
        disparities (S, B, N, 8h, 8w) and residuals (S, B, E, h, w, 2).
        """
        dev = images.device
        ii = torch.as_tensor(ii, device=dev).reshape(-1).long()
        jj = torch.as_tensor(jj, device=dev).reshape(-1).long()
        E = ii.shape[0]
        if edge_mask is None:
            edge_mask = torch.ones((E,), dtype=torch.bool, device=dev)
        edge_mask = torch.as_tensor(edge_mask, device=dev).bool()
        B, N = images.shape[:2]
        ht, wd = images.shape[2] // 8, images.shape[3] // 8

        fmaps, net_all, inp_all = self.extract_features(images)
        net = net_all[:, ii]
        inp = inp_all[:, ii]
        pyramid = corr_ops.build_pyramid(
            corr_ops.corr_volume(fmaps[:, ii], fmaps[:, jj]))

        coords0 = projective.coords_grid(ht, wd, device=dev)
        coords1, _ = projective.projective_transform(Gs, disps, intrinsics,
                                                     ii, jj)
        target = coords1

        m_e = edge_mask[None, :, None, None, None].float()   # (1,E,1,1,1)
        # (B, E) folds into the leading axis for the update operator;
        # per-frame segments with a dump row for padded edges
        seg1 = torch.where(edge_mask, ii, torch.full_like(ii, N))
        seg_ids = (seg1.repeat(B) + torch.arange(B, device=dev)
                   .repeat_interleave(E) * (N + 1))

        def fold(x):
            return x.reshape((B * E,) + x.shape[2:])

        def step(Gs, disps, net, target, coords1):
            Gs, disps = Gs.detach(), disps.detach()
            coords1, target = coords1.detach(), target.detach()

            corr = corr_ops.lookup_pyramid(pyramid, coords1)
            resd = target - coords1
            flow = coords1 - coords0
            motion = torch.cat([flow, resd], dim=-1).clamp(-64.0, 64.0)

            net_f, delta, weight, eta, upmask = self.update(
                fold(net), fold(inp), fold(corr), fold(motion),
                ix=seg_ids, nseg=B * (N + 1), with_upmask=True)
            net = net_f.reshape(B, E, ht, wd, 128)
            delta = delta.reshape(B, E, ht, wd, 2)
            weight = weight.reshape(B, E, ht, wd, 2) * m_e
            eta = eta.reshape(B, N + 1, ht, wd)[:, :N]
            upmask = upmask.reshape(B, N + 1, ht, wd, 8 * 8 * 9)[:, :N]

            target = coords1 + delta

            for _ in range(2):
                Gs, disps = geom_ba.ba(target, weight, eta, Gs, disps,
                                       intrinsics, ii, jj, fixedp=fixedp)

            coords1, valid = projective.projective_transform(
                Gs, disps, intrinsics, ii, jj)
            residual = valid * (target - coords1) * m_e
            # masked-out pixels can carry non-finite reprojections; keep
            # the residual loss (and its gradients) finite
            residual = torch.where(torch.isfinite(residual), residual,
                                   torch.zeros_like(residual))

            d_up = upsample_disp(
                disps.reshape(B * N, ht, wd),
                upmask.reshape(B * N, ht, wd, -1).float(),
            ).reshape(B, N, 8 * ht, 8 * wd)
            return Gs, disps, net, target, coords1, d_up, residual

        poses_out, disps_out, resid_out = [], [], []
        for _ in range(num_steps):
            if remat and torch.is_grad_enabled():
                out = checkpoint(step, Gs, disps, net, target, coords1,
                                 use_reentrant=False)
            else:
                out = step(Gs, disps, net, target, coords1)
            Gs, disps, net, target, coords1, d_up, residual = out
            poses_out.append(Gs)
            disps_out.append(d_up)
            resid_out.append(residual)
        return (torch.stack(poses_out), torch.stack(disps_out),
                torch.stack(resid_out))
