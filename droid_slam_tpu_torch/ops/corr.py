"""Correlation volumes and windowed bilinear lookups.

Tap/channel ordering matches the reference CUDA sampler and the JAX
package: channel ``ox * (2r+1) + oy`` (x-offset major), sample position
``(x + ox - r, y + oy - r)``, zero contribution from out-of-bounds
bilinear corners.

Every windowed lookup goes through ONE function, `lookup_flat`, on a 4-D
view (E, h2, w2, Q) of the volume with arbitrary strides:
  * query-last volumes (E, h2, w2, Q) — the frontend's cached edge
    pyramid (runtime/fused.py), the layout of the TPU kernel it replaces;
  * query-major planes (Q, h2, w2), viewed as (1, h2, w2, Q) — the
    motion filter's one-edge pyramid and the on-the-fly ("alt") path of
    the boot graph, backend and trajectory filler.
A CUDA tensor goes to the hand-written kernel (csrc/corr_lookup.cu); a
CPU tensor goes to the plain PyTorch version `lookup_flat_reference`.
"""

import ctypes

import torch
from torch.nn import functional as F

NUM_LEVELS = 4
RADIUS = 3

# launches of the CUDA lookup kernel (only `lookup_flat_cuda` adds to it)
_LAUNCHES = {"corr_lookup": 0}


def launch_counts():
    return dict(_LAUNCHES)


def reset_launch_counts():
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def _check_radius(radius):
    if radius != RADIUS:
        raise ValueError(
            f"the correlation lookup only supports radius={RADIUS} "
            f"(got {radius})")


def _check_lookup_args(vol, coords):
    if vol.ndim != 4:
        raise ValueError(f"vol must be a 4-D (E, h2, w2, Q) view, got "
                         f"{tuple(vol.shape)}")
    E, _, _, Qv = vol.shape
    if coords.ndim != 3 or coords.shape[0] != E or coords.shape[2] != 2:
        raise ValueError(f"coords must be (E={E}, Q, 2), got "
                         f"{tuple(coords.shape)}")
    if coords.shape[1] > Qv:
        raise ValueError(f"{coords.shape[1]} queries but the volume holds "
                         f"{Qv}")
    if vol.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"vol must be float32 or bfloat16, got {vol.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if coords.device != vol.device:
        raise ValueError("vol and coords must be on one device")


def lookup_flat_reference(vol, coords, radius=RADIUS):
    """Plain PyTorch version of the lookup kernel (same f32 arithmetic).

    Args:
      vol: (E, h2, w2, Qv) view, any strides, float32 or bfloat16.
      coords: (E, Q, 2) float32 [x, y] in level units, Q <= Qv.
    Returns:
      (E, Q, (2r+1)²) float32 taps, x-offset-major.
    """
    _check_radius(radius)
    _check_lookup_args(vol, coords)
    E, h2, w2, _ = vol.shape
    Q = coords.shape[1]
    rd = 2 * radius + 1
    if h2 * w2 == 0 or Q == 0 or E == 0:
        return coords.new_zeros((E, Q, rd * rd))

    x0f = torch.floor(coords[..., 0])
    y0f = torch.floor(coords[..., 1])
    dx = (coords[..., 0] - x0f)[..., None, None]
    dy = (coords[..., 1] - y0f)[..., None, None]
    x0 = torch.clamp(x0f, -2e4, 2e4).to(torch.int64)
    y0 = torch.clamp(y0f, -2e4, 2e4).to(torch.int64)

    offs = torch.arange(rd + 1, device=vol.device) - radius      # (8,)
    ys = y0[..., None] + offs                                    # (E,Q,8)
    xs = x0[..., None] + offs
    ok = (((ys >= 0) & (ys < h2))[..., :, None]
          & ((xs >= 0) & (xs < w2))[..., None, :])               # (E,Q,8,8)
    idx = (ys.clamp(0, h2 - 1)[..., :, None] * w2
           + xs.clamp(0, w2 - 1)[..., None, :])
    planes = vol.permute(0, 3, 1, 2)[:, :Q].reshape(E, Q, h2 * w2)
    T = torch.gather(planes, 2, idx.reshape(E, Q, -1)).float()
    T = torch.where(ok.reshape(E, Q, -1), T, 0.0).reshape(E, Q, rd + 1,
                                                          rd + 1)
    tx = (1.0 - dx) * T[..., :rd] + dx * T[..., 1:]              # (E,Q,8,7)
    taps = (1.0 - dy) * tx[..., :rd, :] + dy * tx[..., 1:, :]    # [oy, ox]
    return taps.transpose(-1, -2).reshape(E, Q, rd * rd)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def lookup_flat_cuda(vol, coords, radius=RADIUS):
    """Launch the CUDA lookup kernel (same contract as the reference)."""
    _check_radius(radius)
    _check_lookup_args(vol, coords)
    if not vol.is_cuda:
        raise ValueError("lookup_flat_cuda needs CUDA tensors")
    from .cuda_build import load

    fn = load("corr_lookup").corr_lookup      # one object per library
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                       ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                       ctypes.c_void_p]
    E, h2, w2, _ = vol.shape
    Q = coords.shape[1]
    coords = coords.contiguous()
    out = torch.empty((E, Q, (2 * radius + 1) ** 2), device=vol.device,
                      dtype=torch.float32)
    if E * Q == 0:
        return out
    se, sy, sx, sq = vol.stride()
    stream = torch.cuda.current_stream(vol.device).cuda_stream
    err = fn(vol.data_ptr(), _DTYPE_CODE[vol.dtype], coords.data_ptr(),
             out.data_ptr(), E, Q, h2, w2, se, sy, sx, sq, stream)
    if err != 0:
        raise RuntimeError(f"corr_lookup kernel launch failed: CUDA error "
                           f"{err}")
    _LAUNCHES["corr_lookup"] += 1
    return out


def lookup_flat(vol, coords, radius=RADIUS):
    """Windowed lookup on a (E, h2, w2, Q) view: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if vol.is_cuda:
        return lookup_flat_cuda(vol, coords, radius)
    if vol.device.type != "cpu":
        raise ValueError(f"unsupported device {vol.device}")
    return lookup_flat_reference(vol, coords, radius)


def query_major_view(planes):
    """(Q, h2, w2) or (E, Q, h2, w2) planes -> the (E, h2, w2, Q) strided
    view `lookup_flat` takes (no copy)."""
    if planes.ndim == 3:
        planes = planes[None]
    return planes.permute(0, 2, 3, 1)


# ---------------------------------------------------------------------------
# precomputed volumes
# ---------------------------------------------------------------------------


def corr_volume(fmap1, fmap2):
    """All-pairs volume: (B, N, H, W, C) x2 -> (B, N, H, W, H, W) f32
    = <fmap1/4, fmap2/4>."""
    B, N, H, W, C = fmap1.shape
    f1 = (fmap1.float() / 4.0).reshape(B * N, H * W, C)
    f2 = (fmap2.float() / 4.0).reshape(B * N, H * W, C)
    corr = torch.bmm(f1, f2.transpose(1, 2))
    return corr.reshape(B, N, H, W, H, W)


def _avg_pool2(x):
    """2×2 stride-2 average pool over the last two dims of (..., H, W),
    flooring odd sizes."""
    shape = x.shape
    H, W = shape[-2] // 2 * 2, shape[-1] // 2 * 2
    x = x[..., :H, :W].reshape(shape[:-2] + (H // 2, 2, W // 2, 2))
    return x.mean(dim=(-3, -1))


def build_pyramid(volume, num_levels=NUM_LEVELS):
    """(B, N, H, W, H2, W2) -> list of (B, N, H, W, H2/2^l, W2/2^l)."""
    pyramid = [volume]
    for _ in range(num_levels - 1):
        volume = _avg_pool2(volume)
        pyramid.append(volume)
    return pyramid


def lookup_level(volume_level, coords, radius=RADIUS):
    """(B, N, H, W, h2, w2) level, coords (B, N, H, W, 2) in level units
    -> (B, N, H, W, (2r+1)²) taps."""
    B, N, H, W, h2, w2 = volume_level.shape
    Q = B * N * H * W
    planes = volume_level.reshape(Q, h2, w2)
    taps = lookup_flat(query_major_view(planes), coords.reshape(1, Q, 2),
                       radius)
    return taps.reshape(B, N, H, W, -1)


def lookup_pyramid(pyramid, coords, radius=RADIUS):
    """Pyramid lookup, coords (B, N, H, W, 2) at level-0 resolution ->
    (B, N, H, W, L·(2r+1)²) f32 (the update operator's corr input)."""
    outs = [lookup_level(vol, coords / (2.0 ** l), radius)
            for l, vol in enumerate(pyramid)]
    return torch.cat(outs, dim=-1)


def lookup_pyramid_flat(vols, coords, radius=RADIUS):
    """Pyramid lookup over cached query-last volumes.

    Args:
      vols: list of (E, h2_l, w2_l, Q) volumes, level 0 first.
      coords: (E, Q, 2) float32 [x, y] at level-0 resolution.
    Returns:
      (E, Q, L·(2r+1)²) f32 taps, level-major channel order.
    """
    outs = [lookup_flat(v, coords / (2.0 ** l), radius)
            for l, v in enumerate(vols)]
    return torch.cat(outs, dim=-1)


# ---------------------------------------------------------------------------
# on-the-fly ("alt") correlation
# ---------------------------------------------------------------------------


def alt_lookup_level(fmap1, fmap2_level, coords, radius=RADIUS,
                     pixel_chunk=0):
    """On-the-fly correlation taps for one level.

    Args:
      fmap1: (E, H, W, C) level-0 source features (already /4).
      fmap2_level: (E, h2, w2, C) pooled target features (already /4).
      coords: (E, H, W, 2) float [x, y] in level units.
      pixel_chunk: if > 0, build the volume for blocks of this many query
        pixels, so the transient is O(E · pixel_chunk · h2·w2).
    Returns:
      (E, H, W, (2r+1)²) f32 taps.

    The block volume is an f32 matmul rounded to bf16 (as in the JAX
    package), in query-major layout, looked up by `lookup_flat`.
    """
    E, H, W, C = fmap1.shape
    h2, w2 = fmap2_level.shape[1:3]
    HW = H * W
    T = (2 * radius + 1) ** 2
    f1 = fmap1.float().reshape(E, HW, C)
    f2 = fmap2_level.float().reshape(E, h2 * w2, C)
    cflat = coords.reshape(E, HW, 2).float()

    def block_taps(f1_b, c_b):
        vol = torch.bmm(f1_b, f2.transpose(1, 2)).to(torch.bfloat16)
        vol = vol.reshape(E, f1_b.shape[1], h2, w2)
        return lookup_flat(query_major_view(vol), c_b.contiguous(), radius)

    if pixel_chunk <= 0 or pixel_chunk >= HW:
        return block_taps(f1, cflat).reshape(E, H, W, T)
    outs = [block_taps(f1[:, lo:lo + pixel_chunk],
                       cflat[:, lo:lo + pixel_chunk])
            for lo in range(0, HW, pixel_chunk)]
    return torch.cat(outs, dim=1).reshape(E, H, W, T)


def alt_lookup_pyramid(pyr1_l0, fmap2_pyramid, coords, radius=RADIUS,
                       pixel_chunk=0):
    """Alt-corr over all levels; same channel layout as lookup_pyramid.
    Pixel blocking applies where the level is large (h2·w2 > 1024)."""
    outs = []
    for l, f2 in enumerate(fmap2_pyramid):
        h2w2 = f2.shape[1] * f2.shape[2]
        pc = pixel_chunk if (pixel_chunk > 0 and h2w2 > 1024) else 0
        outs.append(alt_lookup_level(pyr1_l0, f2, coords / (2.0 ** l),
                                     radius, pc))
    return torch.cat(outs, dim=-1)


def gate_corr_pyramid(pyr1_l0, fmap2_pyramid, radius=RADIUS):
    """Window correlation at the static identity grid (the motion gate).

    At coords0 the sample points x/2^l + off are constants, so each level
    is a static bilinear resample of the pooled map to full resolution
    followed by (2r+1)² zero-padded shifts, each multiply-reduced against
    f1.  Equals alt_lookup_pyramid(pyr1_l0, fmap2_pyramid, coords_grid).

    Args:
      pyr1_l0: (E, H, W, C) level-0 source features (already /4).
      fmap2_pyramid: list of (E, h_l, w_l, C) pooled target features.
    Returns:
      (E, H, W, L·(2r+1)²) f32.
    """
    E, H, W, C = pyr1_l0.shape
    r = radius
    dev = pyr1_l0.device
    f1 = pyr1_l0.float()
    outs = []
    for l, f2 in enumerate(fmap2_pyramid):
        s = 1 << l
        f2 = f2.float()
        h2, w2 = f2.shape[1], f2.shape[2]
        ey = torch.arange(-r * s, H + r * s, device=dev)
        ex = torch.arange(-r * s, W + r * s, device=dev)
        iy = torch.div(ey, s, rounding_mode="floor") + r
        fy = (torch.remainder(ey, s).float() / s)
        ix = torch.div(ex, s, rounding_mode="floor") + r
        fx = (torch.remainder(ex, s).float() / s)
        py = int(iy.max()) + 2 - r - h2
        px = int(ix.max()) + 2 - r - w2
        # pad order for F.pad: (C lo, C hi, W lo, W hi, H lo, H hi)
        f2p = F.pad(f2, (0, 0, r, max(px, 1), r, max(py, 1)))
        ry = (f2p[:, iy] * (1 - fy)[None, :, None, None]
              + f2p[:, iy + 1] * fy[None, :, None, None])
        U = (ry[:, :, ix] * (1 - fx)[None, None, :, None]
             + ry[:, :, ix + 1] * fx[None, None, :, None])
        taps = []
        for ox in range(-r, r + 1):
            for oy in range(-r, r + 1):
                sh = U[:, r * s + oy * s: r * s + oy * s + H,
                       r * s + ox * s: r * s + ox * s + W]
                taps.append(torch.sum(f1 * sh, dim=-1))
        outs.append(torch.stack(taps, dim=-1))
    return torch.cat(outs, dim=-1)
