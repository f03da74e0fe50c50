"""Image geometry of the evaluation streams: resize, undistortion and
stereo rectification, in PyTorch on the host (numpy in, numpy out).

The JAX package's streams call OpenCV for these; this module reproduces
OpenCV's semantics so the port's streams run where OpenCV is not
installed:

    resize_linear(img, H, W)   `cv2.resize(img, (W, H))`, INTER_LINEAR:
                               half-pixel centres, no antialiasing, edge
                               samples clamped
    undistort_rectify_map(K, D, R, P, (H, W))
                               `cv2.initUndistortRectifyMap` for the
                               radial-tangential model k1 k2 p1 p2 [k3
                               [k4 k5 k6]]: a forward map, no iteration
    remap_linear(img, mx, my)  `cv2.remap` with float maps, INTER_LINEAR,
                               zero border
    undistort(img, K, D)       `cv2.undistort`: the map with R = I, P = K,
                               its coordinates rounded to 1/32 pixel

`cv2.undistort` builds a fixed-point map, every source coordinate rounded
to 1/32 pixel (INTER_BITS = 5), so `undistort` rounds the same way before
it samples; a float remap of the unrounded map differs from OpenCV by up
to 4 grey levels near strong edges.  Blends are float32, and uint8
results are rounded to nearest.
"""

import functools

import numpy as np
import torch
from torch.nn import functional as F

# resolution of OpenCV's fixed-point maps: 1/32 pixel
_MAP_STEPS = 32


def _as_hwc(img):
    """(H, W) or (H, W, C) numpy -> (H, W, C) float32 tensor, and whether
    a channel axis was added."""
    a = np.asarray(img)
    t = torch.from_numpy(np.ascontiguousarray(a)).float()
    return (t[..., None], True) if a.ndim == 2 else (t, False)


def _to_dtype(t, squeeze, dtype):
    """Round to the image's integer type (saturating), as OpenCV does."""
    if squeeze:
        t = t[..., 0]
    if np.issubdtype(dtype, np.integer):
        info = np.iinfo(dtype)
        t = torch.round(t).clamp_(info.min, info.max)
    return t.contiguous().numpy().astype(dtype)


def resize_linear(img, height, width):
    """Bilinear resize of an (H, W[, C]) image to (height, width)."""
    t, squeeze = _as_hwc(img)
    out = F.interpolate(t.permute(2, 0, 1)[None], size=(height, width),
                        mode="bilinear", align_corners=False,
                        antialias=False)
    return _to_dtype(out[0].permute(1, 2, 0), squeeze, np.asarray(img).dtype)


def _rectify_map64(K, D, R, P, size):
    """`undistort_rectify_map` in float64."""
    H, W = size
    K = np.asarray(K, np.float64).reshape(3, 3)
    P = np.asarray(P, np.float64).reshape(3, -1)[:, :3]
    R = np.eye(3) if R is None else np.asarray(R, np.float64).reshape(3, 3)
    D = np.asarray(D, np.float64).reshape(-1)
    if len(D) not in (4, 5, 8):
        raise ValueError(f"distortion takes 4, 5 or 8 coefficients "
                         f"(k1 k2 p1 p2 [k3 [k4 k5 k6]]), got {len(D)}")
    k = np.zeros(8)
    k[:len(D)] = D
    k1, k2, p1, p2, k3, k4, k5, k6 = k
    iR = np.linalg.inv(P @ R)
    v, u = np.mgrid[0:H, 0:W].astype(np.float64)
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    Z = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    x, y = X / Z, Y / Z
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = ((1 + ((k3 * r2 + k2) * r2 + k1) * r2)
          / (1 + ((k6 * r2 + k5) * r2 + k4) * r2))
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    return (fx * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + cx,
            fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + cy)


def undistort_rectify_map(K, D, R, P, size):
    """(map_x, map_y) float32 (H, W): for each pixel of the rectified
    image of size (H, W) with camera matrix P (3x3 or 3x4; its first three
    columns) and rotation R (None: identity), the source pixel of a camera
    K with distortion D = k1 k2 p1 p2 [k3 [k4 k5 k6]]."""
    return tuple(m.astype(np.float32)
                 for m in _rectify_map64(K, D, R, P, size))


def remap_linear(img, map_x, map_y):
    """out[v, u] = img sampled bilinearly at (map_x[v, u], map_y[v, u]);
    samples outside the image are 0."""
    t, squeeze = _as_hwc(img)
    H, W, C = t.shape
    mx, my = (torch.from_numpy(np.asarray(m, np.float32)) for m in
              (map_x, map_y))
    x0, y0 = torch.floor(mx), torch.floor(my)
    fx, fy = (mx - x0)[..., None], (my - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    flat = t.reshape(H * W, C)
    out = torch.zeros(x0.shape + (C,))
    for dy, wy in ((0, 1 - fy), (1, fy)):
        for dx, wx in ((0, 1 - fx), (1, fx)):
            xs, ys = x0 + dx, y0 + dy
            ok = (xs >= 0) & (xs < W) & (ys >= 0) & (ys < H)
            idx = (ys.clamp(0, H - 1) * W + xs.clamp(0, W - 1)).reshape(-1)
            tap = flat[idx].reshape(out.shape) * ok[..., None]
            out += wx * wy * tap
    return _to_dtype(out, squeeze, np.asarray(img).dtype)


@functools.lru_cache(maxsize=4)
def _undistort_map(K, D, size):
    """The map of `undistort` (K, D as tuples), its coordinates rounded to
    1/32 pixel; exact in float32.  A stream undistorts every frame with
    the same map, so the last few are kept."""
    return tuple((np.round(m * _MAP_STEPS) / _MAP_STEPS).astype(np.float32)
                 for m in _rectify_map64(np.reshape(K, (3, 3)), D, None,
                                         np.reshape(K, (3, 3)), size))


def undistort(img, K, D):
    """Undistort an image of camera K with distortion D, keeping K."""
    key = tuple(np.asarray(K, np.float64).ravel().tolist())
    return remap_linear(img, *_undistort_map(
        key, tuple(np.asarray(D, np.float64).ravel().tolist()),
        np.asarray(img).shape[:2]))
