"""Shared network building blocks.

The networks keep the JAX package's channels-last layout at their public
methods ((..., H, W, C) in and out) so the port and the reference compare
like with like; inside, convolutions run on NCHW tensors.
"""

import torch
from torch import nn


# gradient magnitude threshold of `grad_clip`
GRAD_CLIP = 0.01


class _GradClip(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        zero = torch.zeros_like(g)
        g = torch.where(torch.abs(g) > GRAD_CLIP, zero, g)
        return torch.where(torch.isnan(g), zero, g)


def grad_clip(x):
    """Identity forward; backward zeroes gradient elements with
    |g| > 0.01 or NaN.  Used on the delta/weight/eta heads to keep the
    backward pass through the unrolled BA stable."""
    return _GradClip.apply(x)


def conv(in_ch, out_ch, kernel=3, stride=1, pad=None):
    """2D conv with explicit symmetric padding (torch floor semantics for
    stride 2, as the JAX package's explicit-padding convs)."""
    if pad is None:
        pad = kernel // 2
    return nn.Conv2d(in_ch, out_ch, kernel, stride=stride, padding=pad)


def instance_norm(x, eps=1e-5):
    """Per-sample, per-channel normalization over the spatial dims of an
    NCHW tensor (affine-free InstanceNorm2d); statistics in float32."""
    xf = x.float()
    mean = xf.mean(dim=(-2, -1), keepdim=True)
    var = xf.var(dim=(-2, -1), keepdim=True, unbiased=False)
    return ((xf - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def to_nchw(x):
    return x.permute(0, 3, 1, 2)


def to_nhwc(x):
    return x.permute(0, 2, 3, 1)
