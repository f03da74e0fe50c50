"""The port's synthetic box scene vs the JAX package's (which resamples
with OpenCV).  Poses, depths and intrinsics are analytic: equal up to
float32 rounding of the pose exponential (1e-6).  Images go through
bilinear resampling in both, with OpenCV's fixed-point weights on one
side: the mean absolute difference must stay under 1 grey level and the
largest under 8."""

import numpy as np
import pytest

from droid_slam_tpu.data.synthetic import render_box_scene as jrender
from droid_slam_tpu_torch.data.synthetic import render_box_scene as trender


@pytest.mark.parametrize("seed,n_obstacles", [(3, 0), (5, 2)])
def test_box_scene_matches_jax(seed, n_obstacles):
    a = jrender(5, 48, 64, seed=seed, n_obstacles=n_obstacles)
    b = trender(5, 48, 64, seed=seed, n_obstacles=n_obstacles)
    np.testing.assert_allclose(b["poses_c2w"], a["poses_c2w"], atol=1e-6)
    np.testing.assert_allclose(b["depths"], a["depths"], atol=1e-5)
    np.testing.assert_array_equal(b["intrinsics"], a["intrinsics"])
    d = np.abs(a["images"].astype(np.float32) - b["images"])
    assert d.mean() < 1.0, d.mean()
    assert d.max() < 8.0, d.max()
    assert b["images"].dtype == np.uint8 and b["images"].shape == (5, 48, 64,
                                                                   3)


def test_stereo_views_come_from_one_scene():
    """The two views of one seed see one scene: the left view is the mono
    render; the right one is the JAX renderer's render of the same seed
    from the left poses offset 0.1 along the left camera's x axis (same
    bound as above); and on a surface of near-constant depth z a left
    pixel reappears f·0.1/z pixels to the left in the right view."""
    from droid_slam_tpu_torch.data.synthetic import render_stereo_box_scene

    st = render_stereo_box_scene(3, 96, 128, seed=6)
    mono = trender(3, 96, 128, seed=6)
    assert st["images"].shape == (3, 2, 96, 128, 3)
    np.testing.assert_array_equal(st["images"][:, 0], mono["images"])
    np.testing.assert_array_equal(st["poses_c2w"], mono["poses_c2w"])

    from droid_slam_tpu.lie import so3
    poses_r = st["poses_c2w"].copy()
    poses_r[:, :3] += np.asarray(so3.act(
        poses_r[:, 3:7], np.tile([0.1, 0.0, 0.0], (3, 1)).astype(np.float32)))
    right = jrender(3, 96, 128, seed=6, poses_c2w=poses_r)
    d = np.abs(right["images"].astype(np.float32) - st["images"][:, 1])
    assert d.mean() < 1.0 and d.max() < 8.0, (d.mean(), d.max())

    fx = st["intrinsics"][0, 0]
    L = st["images"][0, 0].astype(np.float32)
    R = st["images"][0, 1].astype(np.float32)
    z = st["depths"][0]
    good = total = 0
    for y in range(8, 88, 8):
        for x in range(16, 120, 8):
            if np.ptp(z[y - 1:y + 2, x - 2:x + 3]) > 0.01 * z[y, x]:
                continue                       # depth edge
            xr = x - fx * 0.1 / z[y, x]
            x0 = int(np.floor(xr))
            if x0 < 0:
                continue
            a = xr - x0
            total += 1
            good += np.abs(L[y, x] - (1 - a) * R[y, x0]
                           - a * R[y, x0 + 1]).mean() < 10.0
    assert total >= 40 and good / total > 0.9, (good, total)
