"""Correlation volumes and their bilinear lookup, in plain float32.

The all-pairs volume of two feature maps is <f1/4, f2/4>; a pyramid
average-pools its last two axes three times; a lookup reads, at every
level l, the (2r+1)² bilinear taps around coords / 2^l (zero outside the
plane), ordered level-major, then x-offset-major.  Autograd
differentiates the gather, so the volume's gradient is dense.
"""

import torch

NUM_LEVELS = 4
RADIUS = 3


def corr_volume(fmap1, fmap2):
    """(B, N, H, W, C) x2 -> (B, N, H, W, H, W) f32."""
    B, N, H, W, C = fmap1.shape
    f1 = (fmap1.float() / 4.0).reshape(B * N, H * W, C)
    f2 = (fmap2.float() / 4.0).reshape(B * N, H * W, C)
    return torch.bmm(f1, f2.transpose(1, 2)).reshape(B, N, H, W, H, W)


def avg_pool2(x):
    """2×2 stride-2 mean over the last two axes, flooring odd sizes."""
    shape = x.shape
    H, W = shape[-2] // 2 * 2, shape[-1] // 2 * 2
    x = x[..., :H, :W].reshape(shape[:-2] + (H // 2, 2, W // 2, 2))
    return x.mean(dim=(-3, -1))


def build_pyramid(volume, num_levels=NUM_LEVELS):
    pyramid = [volume]
    for _ in range(num_levels - 1):
        volume = avg_pool2(volume)
        pyramid.append(volume)
    return pyramid


def bilinear_taps(planes, coords, h2, w2, radius=RADIUS):
    """planes (Q, h2·w2), coords (Q, 2) [x, y] in plane units -> (Q,
    (2r+1)²) taps, x-offset-major, zero outside the plane."""
    rd = 2 * radius + 1
    x0f = torch.floor(coords[:, 0])
    y0f = torch.floor(coords[:, 1])
    dx = (coords[:, 0] - x0f)[:, None, None]
    dy = (coords[:, 1] - y0f)[:, None, None]
    x0 = torch.clamp(x0f, -2e4, 2e4).long()
    y0 = torch.clamp(y0f, -2e4, 2e4).long()
    offs = torch.arange(rd + 1, device=coords.device) - radius
    ys, xs = y0[:, None] + offs, x0[:, None] + offs
    ok = (((ys >= 0) & (ys < h2))[:, :, None]
          & ((xs >= 0) & (xs < w2))[:, None, :])
    idx = ys.clamp(0, h2 - 1)[:, :, None] * w2 + xs.clamp(0, w2 - 1)[:, None, :]
    Q = coords.shape[0]
    T = torch.gather(planes, 1, idx.reshape(Q, -1)).float().reshape(idx.shape)
    T = torch.where(ok, T, torch.zeros_like(T))
    taps = ((1.0 - dx) * (1.0 - dy) * T[:, :rd, :rd]
            + dx * (1.0 - dy) * T[:, :rd, 1:]
            + (1.0 - dx) * dy * T[:, 1:, :rd]
            + dx * dy * T[:, 1:, 1:])                   # [oy, ox]
    return taps.transpose(1, 2).reshape(Q, rd * rd)


def lookup_pyramid(pyramid, coords, radius=RADIUS):
    """Training lookup: levels (B, N, H, W, h2, w2), coords (B, N, H, W, 2)
    -> (B, N, H, W, L·(2r+1)²) f32."""
    lead = tuple(coords.shape[:4])
    Q = coords.numel() // 2
    c = coords.reshape(Q, 2)
    outs = []
    for lvl, vol in enumerate(pyramid):
        h2, w2 = vol.shape[-2:]
        outs.append(bilinear_taps(vol.reshape(Q, h2 * w2), c / 2.0 ** lvl,
                                  h2, w2, radius))
    return torch.cat(outs, dim=-1).reshape(lead + (-1,))


def pool_pyramid(x, levels=NUM_LEVELS):
    """(E, h, w, C) features -> list of 2×2-average-pooled levels."""
    out = [x]
    for _ in range(levels - 1):
        x = avg_pool2(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        out.append(x)
    return out


def edge_taps(f1, f2, coords, radius=RADIUS, block=512):
    """On-the-fly lookup for edges: f1 (E, h, w, C) source features, f2 (E,
    h, w, C) target features (both as stored, divided by 4 here), coords
    (E, h, w, 2) at level 0 -> (E, h, w, L·(2r+1)²) f32, with every
    volume formed in float32, `block` query pixels at a time."""
    E, h, w, C = f1.shape
    HW = h * w
    a = f1.float().reshape(E, HW, C) / 4.0
    levels = [p / 4.0 for p in pool_pyramid(f2.float())]
    c = coords.reshape(E, HW, 2).float()
    outs = []
    for lo in range(0, HW, block):
        q = a[:, lo:lo + block]
        n = q.shape[1]
        cq = c[:, lo:lo + block].reshape(E * n, 2)
        taps = []
        for lvl, p in enumerate(levels):
            h2, w2 = p.shape[1:3]
            vol = torch.bmm(q, p.reshape(E, h2 * w2, C).transpose(1, 2))
            taps.append(bilinear_taps(vol.reshape(E * n, h2 * w2),
                                      cq / 2.0 ** lvl, h2, w2, radius))
        outs.append(torch.cat(taps, dim=-1).reshape(E, n, -1))
    return torch.cat(outs, dim=1).reshape(E, h, w, -1)
