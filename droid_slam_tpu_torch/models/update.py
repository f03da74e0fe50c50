"""The recurrent update operator.

Corr/flow encoders feed a ConvGRU; a `delta` head (2-ch flow correction)
and a `weight` head (2-ch sigmoid confidence), both gradient-clipped;
`GraphAgg` averages the GRU state over edges that share a source frame
and emits the per-frame BA damping `eta = 0.01·softplus(·)` and the
8×8×9 convex-upsampling mask.

Public tensors are channels-last ((E, H, W, C)), as in the JAX package.
The delta/weight heads run unfused (the JAX package fuses them into one
conv pair for the TPU's matrix unit; the math is the same).
"""

import torch
from torch import nn
from torch.nn import functional as F

from ..ops import scatter
from ..utils.timers import sync_site
from .gru import ConvGRU
from .layers import conv, grad_clip, to_nchw, to_nhwc

COR_PLANES = 4 * (2 * 3 + 1) ** 2  # 196


def segment_mean(x, ix, nseg):
    """Mean of x (E, ...) over segment ids ix (E,); ids >= nseg are
    dropped.  Sums in float32, result in x's dtype.  Returns (nseg, ...)."""
    keep = ix < nseg
    with sync_site("graphagg.mask"):
        idx = ix[keep]
    tot = torch.zeros((nseg,) + x.shape[1:], device=x.device,
                      dtype=torch.float32)
    with sync_site("graphagg.mask"):
        kept = x[keep]
    scatter.index_add_(tot, 0, idx, kept.float())
    # bincount reads the index's least and largest value back: two waits
    with sync_site("graphagg.bincount", 2):
        cnt = torch.bincount(idx, minlength=nseg)
    cnt = cnt.clamp(min=1).float()
    return (tot / cnt.reshape((-1,) + (1,) * (x.ndim - 1))).to(x.dtype)


class GraphAgg(nn.Module):
    def __init__(self):
        super().__init__()
        self.conv1 = conv(128, 128, 3)
        self.conv2 = conv(128, 128, 3)
        self.eta = conv(128, 1, 3)
        self.upmask = conv(128, 8 * 8 * 9, 1, pad=0)

    def forward(self, net, ix, nseg, with_upmask=False):
        """net: (E, 128, H, W) NCHW; ix: (E,) segment ids.

        Returns eta (nseg, H, W) f32 and, with `with_upmask`, the
        convex-upsampling logits (nseg, H, W, 576).
        """
        net = F.relu(self.conv1(net))
        net = segment_mean(net, ix, nseg)
        net = F.relu(self.conv2(net))
        eta = 0.01 * F.softplus(grad_clip(self.eta(net).float()))[:, 0]
        if not with_upmask:
            return eta
        return eta, to_nhwc(self.upmask(net))


class UpdateModule(nn.Module):
    def __init__(self):
        super().__init__()
        self.corr_encoder_0 = conv(COR_PLANES, 128, 1, pad=0)
        self.corr_encoder_2 = conv(128, 128, 3)
        self.flow_encoder_0 = conv(4, 128, 7)
        self.flow_encoder_2 = conv(128, 64, 3)
        self.gru = ConvGRU(128, 128 + 128 + 64)
        self.delta_0 = conv(128, 128, 3)
        self.delta_2 = conv(128, 2, 3)
        self.weight_0 = conv(128, 128, 3)
        self.weight_2 = conv(128, 2, 3)
        self.agg = GraphAgg()

    def forward(self, net, inp, corr, flow=None, ix=None, nseg=None,
                with_upmask=False):
        """One update-operator step.

        Args:
          net:  (E, H, W, 128) GRU hidden state.
          inp:  (E, H, W, 128) context features.
          corr: (E, H, W, 196) correlation taps.
          flow: (E, H, W, 4) motion features, or None for zeros.
          ix:   optional (E,) source-frame segment ids for GraphAgg.
          nseg: segment count for GraphAgg.
          with_upmask: also return GraphAgg's upsampling logits.

        Returns (net, delta, weight[, eta[, upmask]]); net is
        (E, H, W, 128) in the module's dtype, delta/weight are f32
        (E, H, W, 2).
        """
        dt = self.corr_encoder_0.weight.dtype
        E, H, W, _ = net.shape
        net = to_nchw(net.to(dt))
        inp = to_nchw(inp.to(dt))
        if flow is None:
            flow = torch.zeros((E, 4, H, W), device=net.device, dtype=dt)
        else:
            flow = to_nchw(flow.to(dt))

        cor = F.relu(self.corr_encoder_0(to_nchw(corr.to(dt))))
        cor = F.relu(self.corr_encoder_2(cor))
        flo = F.relu(self.flow_encoder_0(flow))
        flo = F.relu(self.flow_encoder_2(flo))

        net = self.gru(net, torch.cat([inp, cor, flo], dim=1))

        delta = grad_clip(self.delta_2(F.relu(self.delta_0(net))).float())
        weight = torch.sigmoid(grad_clip(
            self.weight_2(F.relu(self.weight_0(net))).float()))
        delta, weight = to_nhwc(delta), to_nhwc(weight)

        if ix is None:
            return to_nhwc(net), delta, weight

        agg = self.agg(net, ix, nseg, with_upmask)
        if not with_upmask:
            return to_nhwc(net), delta, weight, agg
        return (to_nhwc(net), delta, weight) + agg


def cvx_upsample(data, mask):
    """Convex-combination 8× upsampling.

    Args:
      data: (B, H, W, C) field to upsample.
      mask: (B, H, W, 8*8*9) logits over the 3×3 neighbourhood per
        subpixel, laid out (9, 8, 8).
    Returns:
      (B, 8H, 8W, C).
    """
    B, H, W, C = data.shape
    mask = torch.softmax(mask.reshape(B, H, W, 9, 8, 8), dim=3)
    # 3×3 neighbourhoods as shifted views of the zero-padded field,
    # neighbour index k = 3·dy + dx (channels stay last: F.unfold would
    # order patches channel-major)
    pad = F.pad(data, (0, 0, 1, 1, 1, 1))
    neigh = torch.stack([pad[:, dy:dy + H, dx:dx + W]
                         for dy in range(3) for dx in range(3)], dim=3)
    up = torch.einsum("bhwkyx,bhwkc->bhwyxc", mask, neigh)
    return up.permute(0, 1, 3, 2, 4, 5).reshape(B, 8 * H, 8 * W, C)


def upsample_disp(disp, mask):
    """disp: (B, H, W) -> (B, 8H, 8W) via cvx_upsample."""
    return cvx_upsample(disp[..., None], mask)[..., 0]
