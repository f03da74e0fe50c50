"""The port's trajectory metrics (geom/align.py) against the JAX
package's `geom/align.py`, on seeded trajectories.  Both are the same
float64 numpy, so the numbers must be equal to the last bit (tolerance
0)."""

import numpy as np
import pytest

from droid_slam_tpu.geom import align as jalign
from droid_slam_tpu_torch.geom import align as talign


def trajectories(seed, n=60):
    """A random-walk ground truth (N, 7) and an estimate: scaled, rotated,
    shifted and noisy."""
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.normal(0, 0.3, (n, 3)), 0)
    q = rng.normal(0, 1, (n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    gt = np.concatenate([t, q], 1)
    th = rng.uniform(0, np.pi)
    R = np.array([[np.cos(th), -np.sin(th), 0], [np.sin(th), np.cos(th), 0],
                  [0, 0, 1]])
    est = gt.copy()
    est[:, :3] = 0.7 * t @ R.T + [1, -2, 0.5] + rng.normal(0, 0.02, (n, 3))
    est[:, 3:] += rng.normal(0, 0.01, (n, 4))
    return gt, est


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_metrics_equal_jax(seed):
    gt, est = trajectories(seed)
    for with_scale in (True, False):
        for a, b in zip(talign.umeyama(est, gt, with_scale),
                        jalign.umeyama(est, gt, with_scale)):
            np.testing.assert_array_equal(a, b)
        assert (talign.ate_rmse(gt, est, correct_scale=with_scale)
                == jalign.ate_rmse(gt, est, correct_scale=with_scale))
        assert (talign.kitti_metric(gt, est, correct_scale=with_scale)
                == jalign.kitti_metric(gt, est, correct_scale=with_scale))
    for delta in (1, 3):
        assert talign.rpe(gt, est, delta) == jalign.rpe(gt, est, delta)
        assert (talign.rpe_pose(gt, est, delta)
                == jalign.rpe_pose(gt, est, delta))
    np.testing.assert_array_equal(talign.se3_matrices(est),
                                  jalign.se3_matrices(est))


def test_diverged_estimate_is_inf_and_associate_equal():
    gt, est = trajectories(3)
    est[5, 0] = np.nan
    assert talign.ate_rmse(gt, est) == jalign.ate_rmse(gt, est) == np.inf
    rng = np.random.default_rng(4)
    a = np.sort(rng.uniform(0, 3, 50))
    b = np.sort(a[::2] + rng.normal(0, 0.01, 25))
    for dt in (0.005, 0.02, 0.08):
        assert talign.associate(a, b, dt) == jalign.associate(a, b, dt)
