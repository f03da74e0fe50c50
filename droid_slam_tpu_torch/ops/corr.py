"""Correlation volumes and windowed bilinear lookups.

Tap/channel ordering matches the reference CUDA sampler and the JAX
package: channel ``ox * (2r+1) + oy`` (x-offset major), sample position
``(x + ox - r, y + oy - r)``, zero contribution from out-of-bounds
bilinear corners.

Every volume is query-major: a query owns one contiguous (h2, w2) plane
per pyramid level, and consecutive queries' planes are adjacent.

The serving path's windowed lookups go through `lookup_pyramid_flat`, on
up to four levels of (E, Q, h2_l, w2_l) planes with coordinates at level-0
resolution: the frontend's cached edge pyramid (runtime/fused.py), and
the motion filter's one-edge pyramid and the on-the-fly ("alt") path of
the boot graph, backend and trajectory filler, whose volumes exist one
block of query pixels at a time; `lookup_flat` is a one-level pyramid.
A CUDA tensor goes to the hand-written kernel (csrc/corr_lookup.cu), one
launch per pyramid; a CPU tensor goes to the plain PyTorch version
`lookup_pyramid_flat_reference`.

The training path looks up contiguous 6-D pyramid levels
(B, N, H, W, h2, w2) through `lookup_pyramid`, which `set_lookup_impl`
routes:
  * "level" (the training default): `lookup_pyramid_level_cuda`, four-corner
    combine — replaces the TPU kernel droid_slam_tpu/ops/corr_pallas.py:
    lookup_level_pallas;
  * "level_v2": `lookup_pyramid_level_v2_cuda`, separable blend — replaces
    lookup_level_pallas_v2;
  * "flat": the serving kernel (no gradient).
Each route is one launch for the whole pyramid (csrc/lookup_pyramid.cuh
is the schedule of all three).  Both "level" routes are differentiable
with respect to the volume: their backward is the third kernel of
csrc/corr_lookup_level.cu (`lookup_level_backward_cuda`), once per level.
Each kernel has a plain PyTorch version with the same operation order
(`lookup_pyramid_level_reference`, `lookup_pyramid_level_v2_reference`,
`lookup_level_backward_reference`) that CPU tensors take; a CUDA tensor
launches the kernel or raises.  `lookup_level_cuda` / `lookup_level_v2_cuda`
and their plain versions are the one-level forms.
"""

import ctypes

import torch
from torch.nn import functional as F

from ..utils.timers import sync_site

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


def _separable_taps(T, dx, dy, radius=RADIUS):
    """(..., 8, 8) windows -> (..., (2r+1)²) taps, x-offset-major: rows
    blended along x, then neighbouring rows along y."""
    rd = 2 * radius + 1
    tx = (1.0 - dx) * T[..., :rd] + dx * T[..., 1:]              # (...,8,7)
    taps = (1.0 - dy) * tx[..., :rd, :] + dy * tx[..., 1:, :]    # [oy, ox]
    return taps.transpose(-1, -2).reshape(T.shape[:-2] + (rd * rd,))


def _corner_taps(T, dx, dy, radius=RADIUS):
    """(..., 8, 8) windows -> (..., (2r+1)²) taps, x-offset-major: the
    four bilinear corner weights times the four window elements."""
    rd = 2 * radius + 1
    taps = ((1.0 - dx) * (1.0 - dy) * T[..., :rd, :rd]
            + dx * (1.0 - dy) * T[..., :rd, 1:]
            + (1.0 - dx) * dy * T[..., 1:, :rd]
            + dx * dy * T[..., 1:, 1:])                          # [oy, ox]
    return taps.transpose(-1, -2).reshape(T.shape[:-2] + (rd * rd,))


def _check_levels(levels, lead_ndim, what):
    """Common checks of a pyramid's levels: 1..NUM_LEVELS tensors of one
    dtype (float32 or bfloat16), device and leading shape."""
    levels = list(levels)
    if not 1 <= len(levels) <= NUM_LEVELS:
        raise ValueError(f"a pyramid has 1..{NUM_LEVELS} levels, got "
                         f"{len(levels)}")
    first = levels[0]
    for v in levels:
        if v.ndim != lead_ndim + 2:
            raise ValueError(f"each level must be {what}, got "
                             f"{tuple(v.shape)}")
        if (v.shape[:lead_ndim] != first.shape[:lead_ndim]
                or v.dtype != first.dtype or v.device != first.device):
            raise ValueError("the levels of a pyramid share their leading "
                             "shape, dtype and device")
    if first.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"volumes must be float32 or bfloat16, got "
                        f"{first.dtype}")
    return levels


def _check_coords(coords, shape, device):
    if tuple(coords.shape) != tuple(shape):
        raise ValueError(f"coords must be {tuple(shape)}, got "
                         f"{tuple(coords.shape)}")
    if coords.dtype != torch.float32:
        raise TypeError(f"coords must be float32, got {coords.dtype}")
    if coords.device != device:
        raise ValueError("volumes and coords must be on one device")


def _check_flat_args(vols, coords, radius):
    _check_radius(radius)
    vols = _check_levels(vols, 2, "(E, Q, h2, w2) planes")
    E, Qv = vols[0].shape[:2]
    if coords.ndim != 3 or coords.shape[1] > Qv:
        raise ValueError(f"coords must be (E={E}, Q<={Qv}, 2), got "
                         f"{tuple(coords.shape)}")
    _check_coords(coords, (E, coords.shape[1], 2), vols[0].device)
    return vols


def lookup_pyramid_flat_reference(vols, coords, radius=RADIUS):
    """Plain PyTorch version of the serving lookup kernel (same f32
    arithmetic): each level's window blended along x, then along y.

    Args:
      vols: 1..4 levels of (E, Qv, h2_l, w2_l) query-major planes, level 0
        first, float32 or bfloat16.
      coords: (E, Q, 2) float32 [x, y] at level-0 resolution, Q <= Qv.
    Returns:
      (E, Q, L·(2r+1)²) float32 taps, level-major, x-offset-major.
    """
    vols = _check_flat_args(vols, coords, radius)
    E, Q = coords.shape[:2]
    rd = 2 * radius + 1
    outs = []
    for l, vol in enumerate(vols):
        h2, w2 = vol.shape[2:]
        if h2 * w2 == 0 or Q == 0 or E == 0:
            outs.append(coords.new_zeros((E, Q, rd * rd)))
            continue
        planes = vol[:, :Q].reshape(E, Q, h2 * w2)
        T, dx, dy = _gather_window(planes, coords / (2.0 ** l), h2, w2,
                                   radius)
        outs.append(_separable_taps(T, dx, dy, radius))
    return torch.cat(outs, dim=-1)


_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_PYRAMID_ARGTYPES = [
    ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]


def _pyramid_args(levels):
    """Contiguous levels (kept alive by the caller) and the leading C
    arguments of a pyramid kernel: pointers, plane sizes, count, dtype."""
    levels = [v.contiguous() for v in levels]
    n = len(levels)
    return levels, (
        (ctypes.c_void_p * n)(*[v.data_ptr() for v in levels]),
        (ctypes.c_int * n)(*[v.shape[-2] for v in levels]),
        (ctypes.c_int * n)(*[v.shape[-1] for v in levels]),
        n, _DTYPE_CODE[levels[0].dtype])


def lookup_pyramid_flat_cuda(vols, coords, radius=RADIUS):
    """Launch the serving lookup kernel, once for the whole pyramid
    (contract of `lookup_pyramid_flat_reference`)."""
    vols = _check_flat_args(vols, coords, radius)
    if not coords.is_cuda:
        raise ValueError("lookup_pyramid_flat_cuda needs CUDA tensors")
    from .cuda_build import load

    fn = load("corr_lookup").corr_lookup      # one object per library
    if fn.argtypes is None:
        fn.restype = ctypes.c_int
        fn.argtypes = _PYRAMID_ARGTYPES + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    E, Q = coords.shape[:2]
    out = torch.empty((E, Q, len(vols) * (2 * radius + 1) ** 2),
                      device=coords.device, dtype=torch.float32)
    if E * Q == 0:
        return out
    vols, args = _pyramid_args(vols)
    coords = coords.contiguous()
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    err = fn(*args, coords.data_ptr(), out.data_ptr(), E * Q, Q,
             vols[0].shape[1], stream)
    if err != 0:
        raise RuntimeError(f"corr_lookup kernel launch failed: CUDA error "
                           f"{err}")
    _LAUNCHES["corr_lookup"] += 1
    return out


def _on_cuda(t):
    if t.is_cuda:
        return True
    if t.device.type != "cpu":
        raise ValueError(f"unsupported device {t.device}")
    return False


def lookup_pyramid_flat(vols, coords, radius=RADIUS):
    """Pyramid lookup over query-major planes (contract of
    `lookup_pyramid_flat_reference`): the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if _on_cuda(coords):
        return lookup_pyramid_flat_cuda(vols, coords, radius)
    return lookup_pyramid_flat_reference(vols, coords, radius)


def lookup_flat(planes, coords, radius=RADIUS):
    """One level: (E, Qv, h2, w2) planes, coords (E, Q, 2) in level units
    -> (E, Q, (2r+1)²) taps."""
    return lookup_pyramid_flat([planes], coords, radius)


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


def _check_level_args(pyramid, coords, radius):
    _check_radius(radius)
    pyramid = _check_levels(pyramid, 4, "(B, N, H, W, h2, w2)")
    _check_coords(coords, tuple(pyramid[0].shape[:4]) + (2,),
                  pyramid[0].device)
    return pyramid


def _level_taps(volume_level, coords, radius, combine):
    """One level's plain lookup: (B, N, H, W, h2, w2), coords in level
    units -> (B, N, H, W, (2r+1)²) f32, windows combined by `combine`."""
    h2, w2 = volume_level.shape[-2:]
    Q = coords.numel() // 2
    lead = tuple(coords.shape[:4])
    if Q == 0 or h2 * w2 == 0:
        return coords.new_zeros(lead + ((2 * radius + 1) ** 2,))
    T, dx, dy = _gather_window(volume_level.reshape(Q, h2 * w2),
                               coords.reshape(Q, 2), h2, w2, radius)
    return combine(T, dx, dy, radius).reshape(lead + (-1,))


def _pyramid_taps(pyramid, coords, radius, combine):
    pyramid = _check_level_args(pyramid, coords, radius)
    return torch.cat([_level_taps(vol, coords / (2.0 ** l), radius, combine)
                      for l, vol in enumerate(pyramid)], dim=-1)


def lookup_pyramid_level_reference(pyramid, coords, radius=RADIUS):
    """Plain PyTorch version of `lookup_pyramid_level_cuda`: the 8×8 window
    of each query's plane at every level, combined with the four bilinear
    corner weights.

    Args:
      pyramid: 1..4 levels of (B, N, H, W, h2_l, w2_l), level 0 first,
        float32 or bfloat16.
      coords: (B, N, H, W, 2) float32 [x, y] at level-0 resolution.
    Returns:
      (B, N, H, W, L·(2r+1)²) float32 taps, level-major, x-offset-major.
    """
    return _pyramid_taps(pyramid, coords, radius, _corner_taps)


def lookup_pyramid_level_v2_reference(pyramid, coords, radius=RADIUS):
    """Plain PyTorch version of `lookup_pyramid_level_v2_cuda` (contract of
    `lookup_pyramid_level_reference`): each level's window rows blended
    along x, then neighbouring rows blended along y."""
    return _pyramid_taps(pyramid, coords, radius, _separable_taps)


def lookup_level_reference(volume_level, coords, radius=RADIUS):
    """One level of `lookup_pyramid_level_reference`: coords in level
    units -> (B, N, H, W, (2r+1)²) taps."""
    return lookup_pyramid_level_reference([volume_level], coords, radius)


def lookup_level_v2_reference(volume_level, coords, radius=RADIUS):
    """One level of `lookup_pyramid_level_v2_reference` (contract of
    `lookup_level_reference`)."""
    return lookup_pyramid_level_v2_reference([volume_level], coords, radius)


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
        for fn in (lib.lookup_level_fwd, lib.lookup_level_v2_fwd):
            fn.restype = ctypes.c_int
            fn.argtypes = _PYRAMID_ARGTYPES + [ctypes.c_void_p]
        lib.lookup_level_bwd.restype = ctypes.c_int
        lib.lookup_level_bwd.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    return lib


def _launch_level_pyramid(name, pyramid, coords, radius):
    """Launch the pyramid kernel `name` of csrc/corr_lookup_level.cu once
    for the whole pyramid."""
    pyramid = _check_level_args(pyramid, coords, radius)
    if not coords.is_cuda:
        raise ValueError(f"{name} needs CUDA tensors")
    Q = coords.numel() // 2
    out = torch.empty(
        tuple(coords.shape[:4]) + (len(pyramid) * (2 * radius + 1) ** 2,),
        device=coords.device, dtype=torch.float32)
    if Q == 0:
        return out
    pyramid, args = _pyramid_args(pyramid)
    coords = coords.contiguous()
    stream = torch.cuda.current_stream(coords.device).cuda_stream
    err = getattr(_level_lib(), name)(*args, coords.data_ptr(),
                                      out.data_ptr(), Q, stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _LAUNCHES[name] += 1
    return out


def lookup_pyramid_level_cuda(pyramid, coords, radius=RADIUS):
    """Launch the four-corner lookup kernel, once for the whole pyramid
    (contract of `lookup_pyramid_level_reference`)."""
    return _launch_level_pyramid("lookup_level_fwd", pyramid, coords, radius)


def lookup_pyramid_level_v2_cuda(pyramid, coords, radius=RADIUS):
    """Launch the separable lookup kernel, once for the whole pyramid
    (contract of `lookup_pyramid_level_v2_reference`)."""
    return _launch_level_pyramid("lookup_level_v2_fwd", pyramid, coords,
                                 radius)


def lookup_level_cuda(volume_level, coords, radius=RADIUS):
    """One level through `lookup_pyramid_level_cuda` (contract of
    `lookup_level_reference`)."""
    return lookup_pyramid_level_cuda([volume_level], coords, radius)


def lookup_level_v2_cuda(volume_level, coords, radius=RADIUS):
    """One level through `lookup_pyramid_level_v2_cuda` (contract of
    `lookup_level_v2_reference`)."""
    return lookup_pyramid_level_v2_cuda([volume_level], coords, radius)


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


def _level_backward(grad_taps, coords, plane, radius, dtype):
    """Gradient of one level's lookup with respect to its volume."""
    fn = (lookup_level_backward_cuda if _on_cuda(grad_taps)
          else lookup_level_backward_reference)
    return fn(grad_taps.contiguous().float(), coords, *plane,
              radius).to(dtype)


def _refuse_coords_grad(coords):
    if coords.requires_grad:
        raise ValueError("the level lookup has no gradient with respect to "
                         "coords: detach them first")


# (kernel wrapper, plain version) of each differentiable route
_PYRAMID_FORWARDS = {
    "level": (lookup_pyramid_level_cuda, lookup_pyramid_level_reference),
    "level_v2": (lookup_pyramid_level_v2_cuda,
                 lookup_pyramid_level_v2_reference),
}


class _LookupPyramid(torch.autograd.Function):
    """Differentiable pyramid lookup of route `impl` ("level": four-corner
    combine, "level_v2": separable): the forward is one launch of the
    route's CUDA kernel for CUDA tensors and its plain version for CPU
    tensors; the backward runs the backward kernel (or its plain version)
    once per level on that level's channels.  Coordinates get no gradient
    (training detaches them before the lookup)."""

    @staticmethod
    def forward(ctx, coords, radius, impl, *pyramid):
        _refuse_coords_grad(coords)
        kernel, plain = _PYRAMID_FORWARDS[impl]
        fn = kernel if _on_cuda(coords) else plain
        ctx.save_for_backward(coords)
        ctx.radius = radius
        ctx.planes = [tuple(v.shape[-2:]) for v in pyramid]
        ctx.vol_dtype = pyramid[0].dtype
        return fn(pyramid, coords, radius)

    @staticmethod
    def backward(ctx, grad_taps):
        coords, = ctx.saved_tensors
        T = (2 * ctx.radius + 1) ** 2
        grads = [
            _level_backward(grad_taps[..., l * T:(l + 1) * T],
                            coords / (2.0 ** l), plane, ctx.radius,
                            ctx.vol_dtype)
            if ctx.needs_input_grad[3 + l] else None
            for l, plane in enumerate(ctx.planes)]
        return (None, None, None, *grads)


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


def lookup_pyramid_as_flat(pyramid, coords, radius=RADIUS):
    """The 6-D pyramid lookup through `lookup_pyramid_flat`, every level's
    planes as one edge (the serving kernel; no gradient)."""
    lead = tuple(coords.shape[:4])
    Q = coords.numel() // 2
    taps = lookup_pyramid_flat(
        [v.reshape((1, Q) + tuple(v.shape[-2:])) for v in pyramid],
        coords.reshape(1, Q, 2), radius)
    return taps.reshape(lead + (-1,))


def _impl(impl):
    impl = _lookup_impl if impl is None else impl
    if impl not in LOOKUP_IMPLS:
        raise ValueError(f"unknown lookup impl {impl!r}")
    return impl


def lookup_level(volume_level, coords, radius=RADIUS, impl=None):
    """(B, N, H, W, h2, w2) level, coords (B, N, H, W, 2) in level units
    -> (B, N, H, W, (2r+1)²) taps, by route `impl` (default: the one
    `set_lookup_impl` chose)."""
    return lookup_pyramid([volume_level], coords, radius, impl)


def lookup_pyramid(pyramid, coords, radius=RADIUS, impl=None):
    """Pyramid lookup, coords (B, N, H, W, 2) at level-0 resolution ->
    (B, N, H, W, L·(2r+1)²) f32 (the update operator's corr input), one
    launch for the whole pyramid on every route."""
    impl = _impl(impl)
    if impl == "flat":
        return lookup_pyramid_as_flat(pyramid, coords, radius)
    return _LookupPyramid.apply(coords, radius, impl, *pyramid)


# ---------------------------------------------------------------------------
# on-the-fly ("alt") correlation
# ---------------------------------------------------------------------------


def alt_lookup_pyramid(pyr1_l0, fmap2_pyramid, coords, radius=RADIUS,
                       pixel_chunk=0):
    """On-the-fly correlation taps over all levels; same channel layout as
    `lookup_pyramid`.

    Args:
      pyr1_l0: (E, H, W, C) level-0 source features (already /4).
      fmap2_pyramid: list of (E, h2_l, w2_l, C) pooled target features
        (already /4), level 0 first.
      coords: (E, H, W, 2) float [x, y] at level-0 resolution.
      pixel_chunk: if > 0 and level 0 is large (h2·w2 > 1024), the volumes
        are built for blocks of this many query pixels, so the transient
        is O(E · pixel_chunk · Σ_l h2_l·w2_l).
    Returns:
      (E, H, W, L·(2r+1)²) f32 taps.

    Each block's volumes are f32 matmuls rounded to bf16 (as in the JAX
    package), query-major, looked up by one `lookup_pyramid_flat` call for
    all levels.
    """
    E, H, W, C = pyr1_l0.shape
    HW = H * W
    f1 = pyr1_l0.float().reshape(E, HW, C)
    planes = [tuple(f2.shape[1:3]) for f2 in fmap2_pyramid]
    f2s = [f2.float().reshape(E, h2 * w2, C).transpose(1, 2)
           for f2, (h2, w2) in zip(fmap2_pyramid, planes)]
    cflat = coords.reshape(E, HW, 2).float()
    big = planes[0][0] * planes[0][1] > 1024
    step = pixel_chunk if (big and 0 < pixel_chunk < HW) else HW
    outs = []
    for lo in range(0, HW, step):
        f1_b = f1[:, lo:lo + step]
        vols = [torch.bmm(f1_b, f2).to(torch.bfloat16).reshape(
            (E, f1_b.shape[1]) + plane) for f2, plane in zip(f2s, planes)]
        outs.append(lookup_pyramid_flat(
            vols, cflat[:, lo:lo + step].contiguous(), radius))
    taps = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return taps.reshape(E, H, W, -1)


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
        with sync_site("gate_corr.max", 2):
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
