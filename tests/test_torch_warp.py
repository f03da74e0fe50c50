"""The port's image geometry (data/warp.py) against OpenCV, on tum_tiny
frames.

Tolerance: one grey level everywhere.  OpenCV blends in fixed point, the
port in float32; both round to nearest.  `undistort` rounds its source
coordinates to 1/32 pixel as `cv2.undistort`'s fixed-point map does (a
float remap of the unrounded map is up to 4 levels off near strong
edges).  The rectification maps themselves equal OpenCV's float maps to
float32 rounding (1e-3 pixel).
"""

import glob
import os.path as osp

import cv2
import numpy as np
import pytest

from droid_slam_tpu.data import streams as jstreams
from droid_slam_tpu_torch.data import warp

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
TUM = sorted(glob.glob(osp.join(ROOT, "tests", "fixtures", "tum_tiny",
                                "rgb", "*.png")))
K_TUM = np.array([517.3, 0, 318.6, 0, 516.5, 255.3, 0, 0, 1.0]).reshape(3, 3)
D_TUM = np.array([0.2624, -0.9531, -0.0054, 0.0026, 1.1633])


def within_one_level(got, want):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = np.abs(got.astype(np.int64) - want)
    assert diff.max() <= 1, diff.max()
    return diff


@pytest.mark.parametrize("frame", [0, 3, 9])
def test_undistort_within_one_level_of_cv2(frame):
    img = cv2.imread(TUM[frame])
    diff = within_one_level(warp.undistort(img, K_TUM, D_TUM),
                            cv2.undistort(img, K_TUM, D_TUM))
    assert diff.mean() < 0.02


@pytest.mark.parametrize("size", [(256, 352), (320, 512), (96, 128),
                                  (384, 512), (200, 300), (480, 640),
                                  (600, 800)])
def test_resize_within_one_level_of_cv2(size):
    img = cv2.imread(TUM[3])
    H, W = size
    within_one_level(warp.resize_linear(img, H, W), cv2.resize(img, (W, H)))
    gray = img[..., 1]
    within_one_level(warp.resize_linear(gray, H, W),
                     cv2.resize(gray, (W, H)))


@pytest.mark.parametrize("side", ["L", "R"])
def test_euroc_maps_and_remap_match_cv2(side):
    K, D, R, P = (getattr(jstreams, f"_EUROC_{n}_{side}") for n in "KDRP")
    mx, my = cv2.initUndistortRectifyMap(K, D, R, P[:3, :3], (752, 480),
                                         cv2.CV_32F)
    gx, gy = warp.undistort_rectify_map(K, D, R, P, (480, 752))
    np.testing.assert_allclose(gx, mx, atol=1e-3)
    np.testing.assert_allclose(gy, my, atol=1e-3)
    img = cv2.resize(cv2.imread(TUM[5]), (752, 480))
    within_one_level(warp.remap_linear(img, gx, gy),
                     cv2.remap(img, mx, my, interpolation=cv2.INTER_LINEAR))


def test_remap_zero_border_and_eight_coefficients():
    """Samples outside the image are zero, and the rational model's
    k4..k6 enter the map as OpenCV's does."""
    img = cv2.imread(TUM[1])
    D = np.array([0.1, -0.05, 0.001, -0.002, 0.01, 0.02, -0.01, 0.005])
    mx, my = cv2.initUndistortRectifyMap(K_TUM, D, None, K_TUM, (640, 480),
                                         cv2.CV_32F)
    gx, gy = warp.undistort_rectify_map(K_TUM, D, None, K_TUM, (480, 640))
    np.testing.assert_allclose(gx, mx, atol=1e-3)
    np.testing.assert_allclose(gy, my, atol=1e-3)
    shift = (np.mgrid[0:480, 0:640][::-1] - 40.5).astype(np.float32)
    got = warp.remap_linear(img, shift[0], shift[1])
    within_one_level(got, cv2.remap(img, shift[0], shift[1],
                                    interpolation=cv2.INTER_LINEAR))
    assert not got[:40].any() and not got[:, :40].any()
    with pytest.raises(ValueError, match="coefficients"):
        warp.undistort_rectify_map(K_TUM, np.zeros(6), None, K_TUM,
                                   (480, 640))
