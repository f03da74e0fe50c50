"""Correlation volumes and windowed bilinear lookups.

Tap/channel ordering matches the reference CUDA sampler and the JAX
package: channel ``ox * (2r+1) + oy`` (x-offset major), sample position
``(x + ox - r, y + oy - r)``, zero contribution from out-of-bounds
bilinear corners.

The serving path's windowed lookups go through `lookup_flat`, on a 4-D
view (E, h2, w2, Q) of the volume with arbitrary strides:
  * query-last volumes (E, h2, w2, Q) — the frontend's cached edge
    pyramid (runtime/fused.py), the layout of the TPU kernel it replaces;
  * query-major planes (Q, h2, w2), viewed as (1, h2, w2, Q) — the
    motion filter's one-edge pyramid and the on-the-fly ("alt") path of
    the boot graph, backend and trajectory filler.
A CUDA tensor goes to the hand-written kernel (csrc/corr_lookup.cu); a
CPU tensor goes to the plain PyTorch version `lookup_flat_reference`.

The training path looks up contiguous 6-D pyramid levels
(B, N, H, W, h2, w2) through `lookup_level`, which `set_lookup_impl`
routes:
  * "level" (the training default): `lookup_level_cuda`, one warp per
    query, four-corner combine — replaces the TPU kernel
    droid_slam_tpu/ops/corr_pallas.py: lookup_level_pallas;
  * "level_v2": `lookup_level_v2_cuda`, eight lanes per query, separable
    blend — replaces lookup_level_pallas_v2;
  * "flat": the serving kernel on a query-major view (no gradient).
Both "level" routes are differentiable with respect to the volume: their
backward is the third kernel of csrc/corr_lookup_level.cu
(`lookup_level_backward_cuda`).  Each kernel has a plain PyTorch version
with the same operation order (`lookup_level_reference`,
`lookup_level_v2_reference`, `lookup_level_backward_reference`) that CPU
tensors take; a CUDA tensor launches the kernel or raises.
"""

import ctypes

import torch
from torch.nn import functional as F

NUM_LEVELS = 4
RADIUS = 3

# launches of each CUDA kernel; only the wrapper that launches a kernel
# adds to its count
_LAUNCHES = {"corr_lookup": 0, "lookup_level_fwd": 0,
             "lookup_level_v2_fwd": 0, "lookup_level_bwd": 0}


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


def _window_index(coords, h2, w2, radius=RADIUS):
    """Flat plane indices of each query's (2r+2)² integer window.

    coords: (..., 2) float32 [x, y].  Returns idx (..., 8, 8) int64 into a
    flattened (h2·w2) plane (clamped into range), ok (..., 8, 8) bool
    (False for window elements outside the plane), and the fractional
    parts dx, dy (..., 1, 1)."""
    rd = 2 * radius + 1
    x0f = torch.floor(coords[..., 0])
    y0f = torch.floor(coords[..., 1])
    dx = (coords[..., 0] - x0f)[..., None, None]
    dy = (coords[..., 1] - y0f)[..., None, None]
    x0 = torch.clamp(x0f, -2e4, 2e4).to(torch.int64)
    y0 = torch.clamp(y0f, -2e4, 2e4).to(torch.int64)
    offs = torch.arange(rd + 1, device=coords.device) - radius   # (8,)
    ys = y0[..., None] + offs                                    # (...,8)
    xs = x0[..., None] + offs
    ok = (((ys >= 0) & (ys < h2))[..., :, None]
          & ((xs >= 0) & (xs < w2))[..., None, :])               # (...,8,8)
    idx = (ys.clamp(0, h2 - 1)[..., :, None] * w2
           + xs.clamp(0, w2 - 1)[..., None, :])
    return idx, ok, dx, dy


def _gather_window(planes, coords, h2, w2, radius=RADIUS):
    """planes (..., h2·w2), coords (..., 2) -> each query's 8×8 integer
    window widened to f32 (zero outside the plane), and dx, dy."""
    idx, ok, dx, dy = _window_index(coords, h2, w2, radius)
    lead = idx.shape[:-2]
    T = torch.gather(planes, -1, idx.reshape(lead + (-1,))).float()
    T = torch.where(ok.reshape(lead + (-1,)), T, 0.0)
    return T.reshape(idx.shape), dx, dy


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

    planes = vol.permute(0, 3, 1, 2)[:, :Q].reshape(E, Q, h2 * w2)
    T, dx, dy = _gather_window(planes, coords, h2, w2, radius)
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


# ---------------------------------------------------------------------------
# lookups on contiguous 6-D pyramid levels (the training path)
# ---------------------------------------------------------------------------


def _check_level_args(volume_level, coords):
    if volume_level.ndim != 6:
        raise ValueError(f"volume_level must be (B, N, H, W, h2, w2), got "
                         f"{tuple(volume_level.shape)}")
    if tuple(coords.shape) != tuple(volume_level.shape[:4]) + (2,):
        raise ValueError(f"coords must be {tuple(volume_level.shape[:4])} "
                         f"+ (2,), got {tuple(coords.shape)}")
    if volume_level.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"volume_level must be float32 or bfloat16, got "
                        f"{volume_level.dtype}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if coords.device != volume_level.device:
        raise ValueError("volume_level and coords must be on one device")


def _level_window(volume_level, coords, radius):
    _check_radius(radius)
    _check_level_args(volume_level, coords)
    h2, w2 = volume_level.shape[-2:]
    Q = coords.numel() // 2
    if Q == 0 or h2 * w2 == 0:
        return None
    return _gather_window(volume_level.reshape(Q, h2 * w2),
                          coords.reshape(Q, 2), h2, w2, radius)


def lookup_level_reference(volume_level, coords, radius=RADIUS):
    """Plain PyTorch version of `lookup_level_cuda`: the 8×8 window of
    each query's plane, combined with the four bilinear corner weights.

    Args:
      volume_level: (B, N, H, W, h2, w2) float32 or bfloat16.
      coords: (B, N, H, W, 2) float32 [x, y] in level units.
    Returns:
      (B, N, H, W, (2r+1)²) float32 taps, x-offset-major.
    """
    rd = 2 * radius + 1
    win = _level_window(volume_level, coords, radius)
    if win is None:
        return coords.new_zeros(coords.shape[:4] + (rd * rd,))
    T, dx, dy = win
    taps = ((1.0 - dx) * (1.0 - dy) * T[..., :rd, :rd]
            + dx * (1.0 - dy) * T[..., :rd, 1:]
            + (1.0 - dx) * dy * T[..., 1:, :rd]
            + dx * dy * T[..., 1:, 1:])                          # [oy, ox]
    return taps.transpose(-1, -2).reshape(coords.shape[:4] + (rd * rd,))


def lookup_level_v2_reference(volume_level, coords, radius=RADIUS):
    """Plain PyTorch version of `lookup_level_v2_cuda` (same contract as
    `lookup_level_reference`): the window rows blended along x, then
    neighbouring rows blended along y."""
    rd = 2 * radius + 1
    win = _level_window(volume_level, coords, radius)
    if win is None:
        return coords.new_zeros(coords.shape[:4] + (rd * rd,))
    T, dx, dy = win
    tx = (1.0 - dx) * T[..., :rd] + dx * T[..., 1:]              # (Q,8,7)
    taps = (1.0 - dy) * tx[..., :rd, :] + dy * tx[..., 1:, :]    # [oy, ox]
    return taps.transpose(-1, -2).reshape(coords.shape[:4] + (rd * rd,))


def _check_backward_args(grad_taps, coords, radius):
    _check_radius(radius)
    T = (2 * radius + 1) ** 2
    if coords.ndim != 5 or coords.shape[-1] != 2:
        raise ValueError(f"coords must be (B, N, H, W, 2), got "
                         f"{tuple(coords.shape)}")
    if tuple(grad_taps.shape) != tuple(coords.shape[:4]) + (T,):
        raise ValueError(f"grad_taps must be {tuple(coords.shape[:4])} + "
                         f"({T},), got {tuple(grad_taps.shape)}")
    if grad_taps.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError("grad_taps and coords must be float32")
    if grad_taps.device != coords.device:
        raise ValueError("grad_taps and coords must be on one device")


def lookup_level_backward_reference(grad_taps, coords, h2, w2,
                                    radius=RADIUS):
    """Plain PyTorch version of `lookup_level_backward_cuda`: the gradient
    of the level lookup with respect to the volume.

    In gather form: window element (a, b) of a query's plane receives the
    gradients of the (at most four) taps it feeds, each with its bilinear
    weight.  A query owns its plane, so nothing is summed across queries.

    Args:
      grad_taps: (B, N, H, W, (2r+1)²) float32, x-offset-major.
      coords: (B, N, H, W, 2) float32 [x, y] in level units.
    Returns:
      (B, N, H, W, h2, w2) float32, zero outside each query's window.
    """
    _check_backward_args(grad_taps, coords, radius)
    rd = 2 * radius + 1
    lead = tuple(coords.shape[:4])
    Q = coords.numel() // 2
    out = grad_taps.new_zeros((Q, h2 * w2))
    if Q == 0 or h2 * w2 == 0:
        return out.reshape(lead + (h2, w2))
    idx, ok, dx, dy = _window_index(coords.reshape(Q, 2), h2, w2, radius)
    G = grad_taps.reshape(Q, rd, rd).transpose(-1, -2)           # [oy, ox]
    Gp = F.pad(G, (1, 1, 1, 1))                                  # (Q,9,9)
    gw = ((1.0 - dx) * (1.0 - dy) * Gp[:, 1:, 1:]
          + dx * (1.0 - dy) * Gp[:, 1:, :-1]
          + (1.0 - dx) * dy * Gp[:, :-1, 1:]
          + dx * dy * Gp[:, :-1, :-1])                           # (Q,8,8)
    gw = torch.where(ok, gw, 0.0)
    # the in-bounds elements of one window are distinct plane positions;
    # out-of-bounds ones add 0 at their clamped index
    out.scatter_add_(1, idx.reshape(Q, -1), gw.reshape(Q, -1))
    return out.reshape(lead + (h2, w2))


def _level_lib():
    """ctypes handle of csrc/corr_lookup_level.cu with its signatures."""
    from .cuda_build import load

    lib = load("corr_lookup_level")
    if lib.lookup_level_fwd.argtypes is None:
        fwd = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
               ctypes.c_void_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
               ctypes.c_void_p]
        for fn in (lib.lookup_level_fwd, lib.lookup_level_v2_fwd):
            fn.restype = ctypes.c_int
            fn.argtypes = fwd
        lib.lookup_level_bwd.restype = ctypes.c_int
        lib.lookup_level_bwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def _launch_level_forward(name, volume_level, coords, radius):
    _check_radius(radius)
    _check_level_args(volume_level, coords)
    if not volume_level.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    h2, w2 = volume_level.shape[-2:]
    Q = coords.numel() // 2
    out_shape = tuple(coords.shape[:4]) + ((2 * radius + 1) ** 2,)
    if Q == 0 or h2 * w2 == 0:
        return coords.new_zeros(out_shape)
    out = torch.empty(out_shape, device=coords.device, dtype=torch.float32)
    vol = volume_level.contiguous()
    coords = coords.contiguous()
    stream = torch.cuda.current_stream(vol.device).cuda_stream
    err = getattr(_level_lib(), name)(
        vol.data_ptr(), _DTYPE_CODE[vol.dtype], coords.data_ptr(),
        out.data_ptr(), Q, h2, w2, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _LAUNCHES[name] += 1
    return out


def lookup_level_cuda(volume_level, coords, radius=RADIUS):
    """Launch the warp-per-query, four-corner lookup kernel (contract of
    `lookup_level_reference`)."""
    return _launch_level_forward("lookup_level_fwd", volume_level, coords,
                                 radius)


def lookup_level_v2_cuda(volume_level, coords, radius=RADIUS):
    """Launch the eight-lanes-per-query, separable lookup kernel (contract
    of `lookup_level_v2_reference`)."""
    return _launch_level_forward("lookup_level_v2_fwd", volume_level, coords,
                                 radius)


def lookup_level_backward_cuda(grad_taps, coords, h2, w2, radius=RADIUS):
    """Launch the lookup's backward kernel (contract of
    `lookup_level_backward_reference`).  The gradient is allocated zeroed
    here; the kernel writes each query's in-bounds window elements."""
    _check_backward_args(grad_taps, coords, radius)
    if not grad_taps.is_cuda:
        raise ValueError("lookup_level_bwd needs CUDA tensors")
    Q = coords.numel() // 2
    out = torch.zeros(tuple(coords.shape[:4]) + (h2, w2),
                      device=coords.device, dtype=torch.float32)
    if Q == 0 or h2 * w2 == 0:
        return out
    grad_taps = grad_taps.contiguous()
    coords = coords.contiguous()
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    err = _level_lib().lookup_level_bwd(
        grad_taps.data_ptr(), coords.data_ptr(), out.data_ptr(), Q, h2, w2,
        stream)
    if err != 0:
        raise RuntimeError(f"lookup_level_bwd kernel launch failed: CUDA "
                           f"error {err}")
    _LAUNCHES["lookup_level_bwd"] += 1
    return out


def _on_cuda(t):
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


class _LookupLevel(torch.autograd.Function):
    """Differentiable level lookup: forward and backward are the CUDA
    kernels for CUDA tensors and their plain versions for CPU tensors.
    Coordinates get no gradient (training detaches them before the
    lookup)."""

    @staticmethod
    def forward(ctx, volume_level, coords, radius, v2):
        if coords.requires_grad:
            raise ValueError("the level lookup has no gradient with respect "
                             "to coords: detach them first")
        if _on_cuda(volume_level):
            fn = lookup_level_v2_cuda if v2 else lookup_level_cuda
        else:
            fn = lookup_level_v2_reference if v2 else lookup_level_reference
        ctx.save_for_backward(coords)
        ctx.radius = radius
        ctx.plane = tuple(volume_level.shape[-2:])
        ctx.vol_dtype = volume_level.dtype
        return fn(volume_level, coords, radius)

    @staticmethod
    def backward(ctx, grad_taps):
        coords, = ctx.saved_tensors
        h2, w2 = ctx.plane
        fn = (lookup_level_backward_cuda if _on_cuda(grad_taps)
              else lookup_level_backward_reference)
        grad = fn(grad_taps.contiguous().float(), coords, h2, w2, ctx.radius)
        return grad.to(ctx.vol_dtype), None, None, None


LOOKUP_IMPLS = ("level", "level_v2", "flat")
_lookup_impl = "level"


def set_lookup_impl(name):
    """Select how `lookup_level` (and so `lookup_pyramid`) runs, for the
    whole process: "level" (default), "level_v2" or "flat" (see the module
    docstring).  Only the first two are differentiable."""
    global _lookup_impl
    if name not in LOOKUP_IMPLS:
        raise ValueError(f"unknown lookup impl {name!r}; one of "
                         f"{LOOKUP_IMPLS}")
    _lookup_impl = name


def lookup_impl():
    return _lookup_impl


def lookup_level_flat(volume_level, coords, radius=RADIUS):
    """The level lookup through `lookup_flat` on a query-major view (the
    serving kernel; no gradient)."""
    B, N, H, W, h2, w2 = volume_level.shape
    Q = B * N * H * W
    planes = volume_level.reshape(Q, h2, w2)
    taps = lookup_flat(query_major_view(planes), coords.reshape(1, Q, 2),
                       radius)
    return taps.reshape(B, N, H, W, -1)


def lookup_level(volume_level, coords, radius=RADIUS, impl=None):
    """(B, N, H, W, h2, w2) level, coords (B, N, H, W, 2) in level units
    -> (B, N, H, W, (2r+1)²) taps, by route `impl` (default: the one
    `set_lookup_impl` chose)."""
    impl = _lookup_impl if impl is None else impl
    if impl not in LOOKUP_IMPLS:
        raise ValueError(f"unknown lookup impl {impl!r}")
    if impl == "flat":
        return lookup_level_flat(volume_level, coords, radius)
    return _LookupLevel.apply(volume_level, coords, radius,
                              impl == "level_v2")


def lookup_pyramid(pyramid, coords, radius=RADIUS, impl=None):
    """Pyramid lookup, coords (B, N, H, W, 2) at level-0 resolution ->
    (B, N, H, W, L·(2r+1)²) f32 (the update operator's corr input)."""
    outs = [lookup_level(vol, coords / (2.0 ** l), radius, impl)
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
