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
