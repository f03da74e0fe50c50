"""Lie-group functions of the PyTorch port vs the JAX package.

Same seeded numpy inputs through both; float32 throughout, so the
tolerance is 1e-5 (a few ulps of the O(1) values, allowing for the
frameworks' different transcendental implementations).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.lie import se3 as jse3
from droid_slam_tpu.lie import so3 as jso3
from droid_slam_tpu_torch.lie import se3 as tse3
from droid_slam_tpu_torch.lie import so3 as tso3

TOL = dict(atol=1e-5, rtol=1e-5)


def _quat(rng, n):
    q = rng.standard_normal((n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _pose(rng, n):
    t = rng.standard_normal((n, 3)).astype(np.float32)
    return np.concatenate([t, _quat(rng, n)], -1)


def _twist(rng, n, small=False):
    x = rng.standard_normal((n, 6)).astype(np.float32)
    if small:
        x *= 1e-5
    return x


def _both(fn_t, fn_j, *args):
    got = fn_t(*[torch.from_numpy(np.array(a)) for a in args]).numpy()
    want = np.asarray(fn_j(*[jnp.asarray(a) for a in args]))
    return got, want


@pytest.mark.parametrize("name", ["mul", "act", "log", "normalize",
                                  "to_matrix", "inv", "exp"])
def test_so3(name):
    rng = np.random.default_rng(0)
    q1, q2 = _quat(rng, 64), _quat(rng, 64)
    v = rng.standard_normal((64, 3)).astype(np.float32)
    args = {"mul": (q1, q2), "act": (q1, v), "log": (q1,),
            "normalize": (3 * q1,), "to_matrix": (q1,), "inv": (q1,),
            "exp": (v,)}[name]
    got, want = _both(getattr(tso3, name), getattr(jso3, name), *args)
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("small", [False, True])
@pytest.mark.parametrize("name", ["exp", "log", "retr", "adjT", "adj",
                                  "mul", "inv", "act", "matrix", "interp"])
def test_se3(name, small):
    rng = np.random.default_rng(1)
    g1, g2 = _pose(rng, 64), _pose(rng, 64)
    xi = _twist(rng, 64, small)
    X = rng.standard_normal((64, 4)).astype(np.float32)
    alpha = rng.random((64, 1)).astype(np.float32)
    if small:   # near-identity group elements exercise the Taylor branches
        g1 = np.asarray(jse3.exp(jnp.asarray(xi)))
    args = {"exp": (xi,), "log": (g1,), "retr": (g1, xi),
            "adjT": (g1, xi), "adj": (g1, xi), "mul": (g1, g2),
            "inv": (g1,), "act": (g1, X), "matrix": (g1,),
            "interp": (g1, g2, alpha)}[name]
    got, want = _both(getattr(tse3, name), getattr(jse3, name), *args)
    tol = TOL if name != "interp" else dict(atol=5e-5, rtol=5e-5)
    np.testing.assert_allclose(got, want, **tol)


def test_identity():
    np.testing.assert_array_equal(tse3.identity((3,)).numpy(),
                                  np.asarray(jse3.identity((3,))))
    np.testing.assert_array_equal(tso3.identity((2,)).numpy(),
                                  np.asarray(jso3.identity((2,))))
