"""Projective geometry and Jacobians of the PyTorch port vs the JAX
package, on seeded inputs, float32 at 1e-5 (relative on the Jacobians,
whose entries reach ~fx·d²)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.geom import projective as jproj
from droid_slam_tpu.lie import se3 as jse3
from droid_slam_tpu_torch.geom import projective as tproj

TOL = dict(atol=1e-5, rtol=1e-5)


def _problem(seed, n=5, h=6, w=8):
    rng = np.random.default_rng(seed)
    xi = 0.1 * rng.standard_normal((1, n, 6)).astype(np.float32)
    poses = np.asarray(jse3.exp(jnp.asarray(xi)))
    disps = (0.3 + rng.random((1, n, h, w))).astype(np.float32)
    intr = np.tile(np.array([[[8.0, 9.0, w / 2, h / 2]]], np.float32),
                   (1, n, 1))
    ii = np.array([0, 1, 2, 3, 4, 2], np.int64)
    jj = np.array([1, 0, 3, 2, 2, 2], np.int64)     # last: stereo edge
    return poses, disps, intr, ii, jj


def test_coords_grid():
    np.testing.assert_array_equal(tproj.coords_grid(4, 5).numpy(),
                                  np.asarray(jproj.coords_grid(4, 5)))


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("return_depth", [False, True])
def test_projective_transform(seed, return_depth):
    poses, disps, intr, ii, jj = _problem(seed)
    got = tproj.projective_transform(
        torch.from_numpy(poses), torch.from_numpy(disps),
        torch.from_numpy(intr), torch.from_numpy(ii), torch.from_numpy(jj),
        return_depth=return_depth)
    want = jproj.projective_transform(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32),
        return_depth=return_depth)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_projective_jacobians(seed):
    poses, disps, intr, ii, jj = _problem(seed)
    coords, valid, (Ji, Jj, Jz) = tproj.projective_transform(
        torch.from_numpy(poses), torch.from_numpy(disps),
        torch.from_numpy(intr), torch.from_numpy(ii), torch.from_numpy(jj),
        jacobian=True)
    wc, wv, (wi, wj, wz) = jproj.projective_transform(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32),
        jacobian=True)
    for g, w in [(coords, wc), (valid, wv), (Ji, wi), (Jj, wj), (Jz, wz)]:
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_iproj_proj_actp():
    rng = np.random.default_rng(3)
    d = (0.5 + rng.random((2, 4, 5))).astype(np.float32)
    intr = np.array([[6.0, 7.0, 2.5, 2.0]] * 2, np.float32)
    X = tproj.iproj(torch.from_numpy(d), torch.from_numpy(intr))
    np.testing.assert_allclose(
        X.numpy(), np.asarray(jproj.iproj(jnp.asarray(d), jnp.asarray(intr))),
        **TOL)
    g = np.asarray(jse3.exp(jnp.asarray(
        0.2 * rng.standard_normal((2, 6)).astype(np.float32))))
    X1, Ja = tproj.actp(torch.from_numpy(g), X, jacobian=True)
    wX1, wJa = jproj.actp(jnp.asarray(g), jnp.asarray(X.numpy()),
                          jacobian=True)
    np.testing.assert_allclose(X1.numpy(), np.asarray(wX1), **TOL)
    np.testing.assert_allclose(Ja.numpy(), np.asarray(wJa), **TOL)
    c, Jp = tproj.proj(X1, torch.from_numpy(intr), jacobian=True,
                       return_depth=True)
    wc, wJp = jproj.proj(wX1, jnp.asarray(intr), jacobian=True,
                         return_depth=True)
    np.testing.assert_allclose(c.numpy(), np.asarray(wc), **TOL)
    np.testing.assert_allclose(Jp.numpy(), np.asarray(wJp), **TOL)
