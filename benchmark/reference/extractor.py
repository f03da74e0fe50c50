"""Feature / context encoders (the reference BasicEncoder).

A 7×7 stride-2 stem, three 2-block residual stages (32→64→128 channels,
strides 1/2/2) and a 1×1 output conv: features at 1/8 input resolution.
fnet: output_dim=128 with instance norm; cnet: output_dim=256, no norm.
"""

from torch import nn
from torch.nn import functional as F

from .layers import conv, instance_norm, to_nchw, to_nhwc

DIM = 32


class ResidualBlock(nn.Module):
    def __init__(self, in_planes, planes, norm, stride=1):
        super().__init__()
        self.norm = norm
        self.conv1 = conv(in_planes, planes, 3, stride)
        self.conv2 = conv(planes, planes, 3, 1)
        self.downsample = (conv(in_planes, planes, 1, stride, pad=0)
                           if stride != 1 else None)

    def _n(self, x):
        return instance_norm(x) if self.norm else x

    def forward(self, x):
        y = F.relu(self._n(self.conv1(x)))
        y = F.relu(self._n(self.conv2(y)))
        if self.downsample is not None:
            x = self._n(self.downsample(x))
        return F.relu(x + y)


class BasicEncoder(nn.Module):
    def __init__(self, output_dim=128, norm_fn="instance"):
        super().__init__()
        if norm_fn not in ("instance", "none"):
            raise ValueError(f"unsupported norm_fn: {norm_fn}")
        norm = norm_fn == "instance"
        self.norm = norm
        self.conv1 = conv(3, DIM, 7, 2)
        in_planes = DIM
        for i, (planes, stride) in enumerate(
            [(DIM, 1), (2 * DIM, 2), (4 * DIM, 2)]
        ):
            setattr(self, f"layer{i + 1}_0",
                    ResidualBlock(in_planes, planes, norm, stride))
            setattr(self, f"layer{i + 1}_1",
                    ResidualBlock(planes, planes, norm, 1))
            in_planes = planes
        self.conv2 = conv(4 * DIM, output_dim, 1, 1, pad=0)

    def forward(self, x):
        """x: (..., H, W, 3) normalized images -> (..., H/8, W/8, C)."""
        lead = x.shape[:-3]
        x = to_nchw(x.reshape((-1,) + x.shape[-3:]))
        x = x.to(self.conv1.weight.dtype)
        x = self.conv1(x)
        x = F.relu(instance_norm(x) if self.norm else x)
        for i in range(3):
            x = getattr(self, f"layer{i + 1}_0")(x)
            x = getattr(self, f"layer{i + 1}_1")(x)
        x = to_nhwc(self.conv2(x))
        return x.reshape(lead + x.shape[1:])
