"""Convolutional GRU with a global-context term (NCHW inside).

A 3×3 gated GRU whose z/r/q gates each receive an additive 1×1-conv
projection of a sigmoid-gated spatial mean of the hidden state.
"""

import torch
from torch import nn

from .layers import conv


class ConvGRU(nn.Module):
    def __init__(self, h_planes=128, in_planes=128 + 128 + 64):
        super().__init__()
        c = h_planes + in_planes
        self.w = conv(h_planes, h_planes, 1, pad=0)
        self.convz = conv(c, h_planes, 3)
        self.convr = conv(c, h_planes, 3)
        self.convq = conv(c, h_planes, 3)
        self.convz_glo = conv(h_planes, h_planes, 1, pad=0)
        self.convr_glo = conv(h_planes, h_planes, 1, pad=0)
        self.convq_glo = conv(h_planes, h_planes, 1, pad=0)

    def forward(self, net, inp):
        """net: (Q, h_planes, H, W); inp: (Q, C_in, H, W)."""
        net_inp = torch.cat([net, inp], dim=1)
        glo = torch.sigmoid(self.w(net)) * net
        glo = glo.float().mean(dim=(-2, -1), keepdim=True).to(net.dtype)

        z = torch.sigmoid(self.convz(net_inp) + self.convz_glo(glo))
        r = torch.sigmoid(self.convr(net_inp) + self.convr_glo(glo))
        q = torch.tanh(self.convq(torch.cat([r * net, inp], dim=1))
                       + self.convq_glo(glo))
        return (1.0 - z) * net + z * q
