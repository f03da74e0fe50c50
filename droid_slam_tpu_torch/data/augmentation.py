"""Training-time augmentation: colour jitter, a random scale and a crop.

The JAX package's `data/augmentation.py` without OpenCV: brightness,
contrast, saturation and hue jitter, a random spatial rescale in
2^[min_scale, 0.25] bounded below so the crop fits, and a centre crop
with the intrinsics adjusted.  The hue shift goes through OpenCV's 8-bit
HSV (H in [0, 180)), written out here in numpy:

    rgb_to_hsv8   `cv2.cvtColor(img, cv2.COLOR_RGB2HSV)` on uint8: the
                  fixed-point division tables (12 fractional bits)
    hsv8_to_rgb   `cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB)` on uint8: the
                  float32 sector formula of OpenCV's vector path

Resizes are `data/warp.resize_linear` (INTER_LINEAR) for images and
`resize_nearest` (INTER_NEAREST) for disparities.  Every draw comes from
the `rng` passed in (a `np.random.Generator`, or anything with its
`random` and `uniform`), in the JAX function's order.
"""

import numpy as np

from .warp import resize_linear, resize_nearest

_HSV_SHIFT = 12
_DIV = np.arange(256, dtype=np.float64)
with np.errstate(divide="ignore"):
    _SDIV = np.where(_DIV > 0, np.rint((255 << _HSV_SHIFT) / _DIV), 0)
    _HDIV = np.where(_DIV > 0, np.rint((180 << _HSV_SHIFT) / (6 * _DIV)), 0)
_SDIV = _SDIV.astype(np.int64)
_HDIV = _HDIV.astype(np.int64)
# tab indices (v, v(1-s), v(1-sh), v(1-s(1-h))) of b, g, r per sector
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1],
                     [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def rgb_to_hsv8(img):
    """(..., 3) uint8 RGB -> (..., 3) uint8 HSV, H in [0, 180)."""
    rgb = np.asarray(img).astype(np.int64)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(b, g), r)
    vmin = np.minimum(np.minimum(b, g), r)
    diff = v - vmin
    half = 1 << (_HSV_SHIFT - 1)
    s = (diff * _SDIV[v] + half) >> _HSV_SHIFT
    h = np.where(v == r, g - b,
                 np.where(v == g, b - r + 2 * diff, r - g + 4 * diff))
    h = (h * _HDIV[diff] + half) >> _HSV_SHIFT
    h = np.where(h < 0, h + 180, h)
    return np.stack([h, s, v], axis=-1).astype(np.uint8)


def hsv8_to_rgb(hsv):
    """(..., 3) uint8 HSV (H in [0, 180)) -> (..., 3) uint8 RGB.

    OpenCV's vector path: 1 - s*h in one fused multiply-add (a float64
    product of two float32 is exact, so one rounding to float32 follows),
    the channel times 255 truncated.  OpenCV's scalar path, which it takes
    for the last pixels of a row that do not fill a vector, rounds to
    nearest instead and can be one level higher there."""
    f32 = np.float32
    hsv = np.asarray(hsv)
    h = hsv[..., 0].astype(f32) * f32(6.0 / 180.0)
    s = hsv[..., 1].astype(f32) * f32(1.0 / 255.0)
    v = hsv[..., 2].astype(f32) * f32(1.0 / 255.0)
    h = np.where(h >= 6, h - f32(6), h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(f32)

    def one_minus(a, b):
        return (1.0 - a.astype(np.float64) * b).astype(f32)

    tab = np.stack([v, v * (f32(1) - s), v * one_minus(s, h),
                    v * one_minus(s, f32(1) - h)], axis=-1)
    bgr = np.take_along_axis(tab, _SECTORS[sector], axis=-1)
    rgb = bgr[..., ::-1] * f32(255)
    return np.clip(np.trunc(rgb), 0, 255).astype(np.uint8)


def _color_jitter(images, rng):
    """images: (N, H, W, 3) float RGB in [0, 255]."""
    brightness = rng.uniform(0.6, 1.4)
    contrast = rng.uniform(0.6, 1.4)
    saturation = rng.uniform(0.6, 1.4)
    hue_shift = rng.uniform(-0.5 / 3.14, 0.5 / 3.14) * 180.0

    out = images * brightness
    mean = out.mean(axis=(-3, -2, -1), keepdims=True)
    out = (out - mean) * contrast + mean
    gray = out.mean(axis=-1, keepdims=True)
    out = (out - gray) * saturation + gray

    if abs(hue_shift) > 1e-3:
        hsv = rgb_to_hsv8(np.clip(out, 0, 255).astype(np.uint8))
        hsv[..., 0] = (hsv[..., 0].astype(np.int32) + int(hue_shift)) % 180
        out = hsv8_to_rgb(hsv).astype(np.float32)
    return np.clip(out, 0, 255)


def augment_sample(images, poses, disps, intrinsics, crop_size, rng,
                   do_color=True):
    """Augment one sample.

    images: (N, H, W, 3) f32; disps: (N, H, W); intrinsics: (N, 4).
    Returns (images, poses, disps, intrinsics) cropped to crop_size.
    """
    N, H, W = images.shape[:3]
    ch, cw = crop_size

    if do_color and rng.random() < 0.5:
        images = _color_jitter(images, rng)

    # random scale: at least enough that the crop fits
    min_scale = max(ch / H, cw / W)
    scale = 2 ** rng.uniform(np.log2(min_scale) if min_scale > 1 else
                             max(np.log2(min_scale), -0.25), 0.25)
    scale = max(scale, min_scale)

    H1, W1 = int(round(H * scale)), int(round(W * scale))
    images = np.stack([resize_linear(images[n], H1, W1) for n in range(N)])
    disps = np.stack([resize_nearest(disps[n], H1, W1) for n in range(N)])
    intrinsics = intrinsics * np.asarray(
        [W1 / W, H1 / H, W1 / W, H1 / H], np.float32)

    # centre crop
    y0 = (H1 - ch) // 2
    x0 = (W1 - cw) // 2
    images = images[:, y0:y0 + ch, x0:x0 + cw]
    disps = disps[:, y0:y0 + ch, x0:x0 + cw]
    intrinsics = intrinsics - np.asarray([0, 0, x0, y0], np.float32)

    return images, poses, disps, intrinsics
