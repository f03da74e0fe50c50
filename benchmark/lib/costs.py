"""Operations and bytes that the work of a cell needs, from its shapes,
whatever implements it; and the H100's peaks they are held against.

Convolution FLOPs count one multiply and one add per weight and output
element (2·Cin·Cout·k²·Hout·Wout; biases, activations and norms are not
counted).  The network's structure is DroidNet's: the BasicEncoder
(fnet 128 channels, cnet 256), the update operator with its ConvGRU over
128 + 320 planes and the GraphAgg head.
"""

import torch

# NVIDIA H100 SXM data sheet, dense rates (700 W)
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

RADIUS = 3
LEVELS = 4
TAPS = (2 * RADIUS + 1) ** 2            # 49 per level
COR_PLANES = LEVELS * TAPS              # 196


def conv_out(n, k, stride):
    return (n + 2 * (k // 2) - k) // stride + 1


def conv_flops(cin, cout, k, h, w):
    """FLOPs of a k×k convolution with an (h, w) output."""
    return 2 * cin * cout * k * k * h * w


def encoder_flops(H, W, out_dim):
    """One image through the BasicEncoder at input (H, W)."""
    h, w = conv_out(H, 7, 2), conv_out(W, 7, 2)
    total = conv_flops(3, 32, 7, h, w)
    cin = 32
    for planes, stride in ((32, 1), (64, 2), (128, 2)):
        h, w = conv_out(h, 3, stride), conv_out(w, 3, stride)
        total += conv_flops(cin, planes, 3, h, w)          # block 0 conv1
        total += 3 * conv_flops(planes, planes, 3, h, w)   # conv2, block 1
        if stride != 1:
            total += conv_flops(cin, planes, 1, h, w)      # downsample
        cin = planes
    return total + conv_flops(128, out_dim, 1, h, w)


def update_flops(E, h, w, nseg=0, upmask=False):
    """The update operator over E edges at (h, w); with `nseg` > 0 also
    GraphAgg over nseg frames (and its upsampling head with `upmask`)."""
    f = (conv_flops(COR_PLANES, 128, 1, h, w) + conv_flops(128, 128, 3, h, w)
         + conv_flops(4, 128, 7, h, w) + conv_flops(128, 64, 3, h, w)
         + conv_flops(128, 128, 1, h, w)                   # GRU context gate
         + 3 * conv_flops(128 + 320, 128, 3, h, w)         # z, r, q
         + 3 * conv_flops(128, 128, 1, 1, 1)               # global terms
         + 2 * conv_flops(128, 128, 3, h, w)               # delta_0, weight_0
         + 2 * conv_flops(128, 2, 3, h, w))                # delta_2, weight_2
    total = E * f
    if nseg:
        total += E * conv_flops(128, 128, 3, h, w)         # agg conv1
        total += nseg * (conv_flops(128, 128, 3, h, w)
                         + conv_flops(128, 1, 3, h, w))    # conv2, eta
        if upmask:
            total += nseg * conv_flops(128, 576, 1, h, w)
    return total


def volume_flops(E, h, w, C=128):
    """The level-0 correlation volumes of E edges (the coarser levels are
    its 2×2 means)."""
    return 2 * E * (h * w) ** 2 * C


def gate_corr_flops(h, w, C=128):
    """The motion gate's taps at the identity grid: 196 dot products of C
    per pixel."""
    return 2 * h * w * COR_PLANES * C


def upsample_flops(n, h, w):
    """Convex upsampling of n disparity maps at (h, w) to 8×: a 9-weight
    combination per output pixel."""
    return 2 * 9 * n * h * w * 64


def window_bytes(coords, h2, w2, elem):
    """Least bytes one level of a lookup must read with these level-scale
    coordinates: the in-bounds elements of each query's 8×8 window."""
    x0 = torch.floor(coords[..., 0]).clamp(-2e4, 2e4).long()
    y0 = torch.floor(coords[..., 1]).clamp(-2e4, 2e4).long()
    offs = torch.arange(2 * RADIUS + 2, device=coords.device) - RADIUS
    nx = ((x0[..., None] + offs >= 0) & (x0[..., None] + offs < w2)).sum(-1)
    ny = ((y0[..., None] + offs >= 0) & (y0[..., None] + offs < h2)).sum(-1)
    return int((nx * ny).sum()) * elem


def pyramid_bytes(coords, planes, elem):
    """Least bytes of a one-launch pyramid lookup with these level-0
    coordinates: every level's window elements and 49 f32 outputs, and
    the coordinates once."""
    q = coords.numel() // 2
    return (sum(window_bytes(coords / 2 ** lvl, h2, w2, elem) + q * TAPS * 4
                for lvl, (h2, w2) in enumerate(planes)) + q * 8)

