"""Dense BA and frame distance of the PyTorch port vs the JAX package.

Small seeded problems: 8 frames of 6×8 pixels, noisy reprojection
targets, random confidences.  The port scatters with `index_add_` where
the JAX package contracts 0/1 selectors, so sums run in another order;
after two Gauss-Newton iterations poses and disparities agree to 1e-4
(the solve amplifies f32 rounding by the conditioning of the damped
system).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.geom import projective as jproj
from droid_slam_tpu.lie import se3 as jse3
from droid_slam_tpu.ops import dba as jdba
from droid_slam_tpu.ops import distance as jdist
from droid_slam_tpu_torch.ops import dba as tdba
from droid_slam_tpu_torch.ops import distance as tdist

BUF, H, W = 8, 6, 8
_STATE = ("poses", "disps", "disps_sens", "intrinsics", "target", "weight",
          "eta")


def _problem(seed, sens=False):
    rng = np.random.default_rng(seed)
    xi = 0.05 * rng.standard_normal((BUF, 6)).astype(np.float32)
    xi[0] = 0
    poses = np.asarray(jse3.exp(jnp.asarray(xi)))
    disps = (0.5 + 0.5 * rng.random((BUF, H, W))).astype(np.float32)
    intr = np.tile(np.array([[10.0, 10.0, W / 2, H / 2]], np.float32),
                   (BUF, 1))
    ii = np.array([0, 1, 1, 2, 2, 3, 3, 4, 5, 4, 6, 0], np.int64)
    jj = np.array([1, 0, 2, 1, 3, 2, 4, 3, 4, 5, 5, 2], np.int64)
    mask = np.ones(len(ii), bool)
    mask[-1] = False
    coords, _ = jproj.projective_transform(
        jnp.asarray(poses)[None], jnp.asarray(disps)[None],
        jnp.asarray(intr)[None], jnp.asarray(ii), jnp.asarray(jj))
    target = (np.asarray(coords[0])
              + 0.3 * rng.standard_normal((len(ii), H, W, 2))).astype(
        np.float32)
    weight = rng.random((len(ii), H, W, 2)).astype(np.float32)
    eta = (1e-3 + 1e-3 * rng.random((BUF, H, W))).astype(np.float32)
    disps_sens = np.zeros_like(disps)
    if sens:
        disps_sens[1:4] = disps[1:4] * (1 + 0.1 * rng.standard_normal(
            (3, H, W))).astype(np.float32)
        disps_sens[2, :2] = 0.0        # partial sensor coverage
    return dict(poses=poses, disps=disps, disps_sens=disps_sens,
                intrinsics=intr, target=target, weight=weight, eta=eta,
                ii=ii, jj=jj, mask=mask)


def _run_both(p, t0, t1, P, K, motion_only=False, iters=2):
    kx, kmask, table = jdba.build_schur_tables(
        p["ii"], p["mask"], t0, t1, K, 16)
    want = jdba.ba(
        *[jnp.asarray(p[k]) for k in _STATE],
        jnp.asarray(p["ii"], jnp.int32), jnp.asarray(p["jj"], jnp.int32),
        jnp.asarray(p["mask"]), jnp.asarray(kx), jnp.asarray(kmask),
        jnp.asarray(table), t0, t1, iters=iters, lm=1e-4, ep=0.1,
        motion_only=motion_only, P=P)
    kx2, kmask2 = tdba.build_schur_tables(p["ii"], p["mask"], t0, t1, K)
    np.testing.assert_array_equal(kx2, kx)
    got = tdba.ba(
        *[torch.from_numpy(np.array(p[k])) for k in _STATE],
        torch.from_numpy(p["ii"]), torch.from_numpy(p["jj"]),
        torch.from_numpy(p["mask"]), torch.from_numpy(kx2),
        torch.from_numpy(kmask2), t0, t1, iters=iters, lm=1e-4, ep=0.1,
        motion_only=motion_only, P=P)
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("sens", [False, True])
def test_ba_matches_jax(seed, sens):
    p = _problem(seed, sens)
    (gp, gd), (wp, wd) = _run_both(p, 1, 6, P=8, K=8)
    assert np.abs(gp - p["poses"]).max() > 1e-3      # the solve moved
    np.testing.assert_allclose(gp, wp, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gd, wd, atol=1e-4, rtol=1e-4)


def test_ba_pose_window_smaller_than_range():
    """P slots cover [t0, t0+P) only; frames past them stay fixed."""
    p = _problem(2)
    (gp, gd), (wp, wd) = _run_both(p, 1, 6, P=3, K=8)
    np.testing.assert_allclose(gp, wp, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gd, wd, atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(gp[4:], p["poses"][4:], atol=1e-6)


def test_ba_motion_only():
    p = _problem(3)
    (gp, gd), (wp, wd) = _run_both(p, 2, 5, P=4, K=8, motion_only=True)
    np.testing.assert_allclose(gp, wp, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(gd, np.maximum(p["disps"], 0.001))


# the static-shape BA of the fused keyframe step (ops/dba_static.py), run
# eagerly as the CPU runs it: (t0, t1, P, K, sens, poison) — random
# problems, a pose window narrower than [t0, t1), the RGB-D prior, kx
# filling its cap K (seven frames), and masked slots holding NaN and inf
STATIC_CASES = {
    "random0": (0, 1, 6, 8, 8, False, False),
    "random1": (1, 1, 6, 8, 8, False, False),
    "narrow": (2, 1, 6, 3, 8, False, False),
    "sens": (0, 1, 6, 8, 8, True, False),
    "kx_cap": (1, 1, 6, 8, 7, False, False),
    "poisoned": (3, 2, 5, 4, 8, True, True),
}


def _run_static(p, t0, t1, P, K, poison):
    """`dba_static.ba` over the problem's edges in a store of 16 slots: the
    last four slots (and the masked edge) are outside the BA mask, point
    outside the buffer and, under `poison`, hold NaN and inf."""
    from droid_slam_tpu_torch.ops import dba_static

    n, extra = len(p["ii"]), 4
    ii = np.concatenate([p["ii"], np.full(extra, 99)])
    jj = np.concatenate([p["jj"], np.full(extra, -5)])
    mask = np.concatenate([p["mask"], np.zeros(extra, bool)])
    target = np.concatenate([p["target"], np.zeros((extra, H, W, 2),
                                                   np.float32)])
    weight = np.concatenate([p["weight"], np.ones((extra, H, W, 2),
                                                  np.float32)])
    if poison:
        target[~mask] = np.nan
        weight[n - 1, :, :, 0] = np.inf
        weight[n:, 1:] = np.nan
    kx, kmask = tdba.build_schur_tables(p["ii"], p["mask"], t0, t1, K)
    idx = dba_static.pack(ii, jj, mask, kx, kmask, t0, t1)
    t = {k: torch.from_numpy(np.array(p[k])) for k in _STATE}
    got = dba_static.ba(
        t["poses"], t["disps"], t["disps_sens"], t["intrinsics"],
        torch.from_numpy(target), torch.from_numpy(weight), t["eta"],
        torch.from_numpy(idx), K=K, P=P, iters=2, lm=1e-4, ep=0.1)
    return [g.numpy() for g in got]


@pytest.mark.parametrize("case", sorted(STATIC_CASES))
def test_static_ba_matches_dba_and_jax(case):
    seed, t0, t1, P, K, sens, poison = STATIC_CASES[case]
    p = _problem(seed, sens)
    (ep, ed), (wp, wd) = _run_both(p, t0, t1, P=P, K=K)
    gp, gd = _run_static(p, t0, t1, P, K, poison)
    assert np.isfinite(gp).all() and np.isfinite(gd).all()
    assert np.abs(gp - p["poses"]).max() > 1e-3      # the solve moved
    for want in ((ep, ed), (wp, wd)):                # ops/dba, JAX
        np.testing.assert_allclose(gp, want[0], atol=1e-4, rtol=1e-4)
        np.testing.assert_allclose(gd, want[1], atol=1e-4, rtol=1e-4)
    if P < t1 - t0:                                  # past the window
        np.testing.assert_array_equal(gp[t0 + P:], ep[t0 + P:])


def test_schur_tables_raise_over_capacity():
    with pytest.raises(ValueError):
        tdba.build_schur_tables(np.arange(6), np.ones(6, bool), 0, 4, 5)


@pytest.mark.parametrize("beta", [0.3, 0.6])
def test_frame_distance_matches_jax(beta):
    p = _problem(4)
    ii = np.array([0, 1, 2, 3, 7, 5], np.int64)
    jj = np.array([1, 0, 4, 3, 2, 6], np.int64)
    got = tdist.frame_distance(
        torch.from_numpy(p["poses"]), torch.from_numpy(p["disps"]),
        torch.from_numpy(p["intrinsics"][0]), torch.from_numpy(ii),
        torch.from_numpy(jj), beta)
    want = jdist.frame_distance(
        jnp.asarray(p["poses"]), jnp.asarray(p["disps"]),
        jnp.asarray(p["intrinsics"][0]), jnp.asarray(ii, jnp.int32),
        jnp.asarray(jj, jnp.int32), beta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    dm = tdist.distance_matrix(
        torch.from_numpy(p["poses"]), torch.from_numpy(p["disps"]),
        torch.from_numpy(p["intrinsics"][0]), 5, beta)
    wm = jdist.distance_matrix(
        jnp.asarray(p["poses"]), jnp.asarray(p["disps"]),
        jnp.asarray(p["intrinsics"][0]), 5, beta)
    np.testing.assert_allclose(dm.numpy(), np.asarray(wm), atol=1e-5,
                               rtol=1e-5)
