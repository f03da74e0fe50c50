"""The training path's level lookups: each plain PyTorch version against
the Pallas kernel it stands for (run in interpret mode, as
tests/test_corr_pallas.py runs them), the backward against jax.grad of
the JAX lookup, and the routing of `lookup_level`."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from droid_slam_tpu.ops import corr as jcorr
from droid_slam_tpu.ops import corr_pallas
from droid_slam_tpu_torch.ops import corr as tcorr

PAIRS = {
    "level": (tcorr.lookup_level_reference, corr_pallas.lookup_level_pallas),
    "level_v2": (tcorr.lookup_level_v2_reference,
                 corr_pallas.lookup_level_pallas_v2),
}


def _pallas(kernel, vol, coords):
    with pltpu.force_tpu_interpret_mode():
        return np.asarray(kernel(vol, coords, radius=3))


@pytest.mark.parametrize("name", sorted(PAIRS))
@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_pallas_f32(name, seed):
    """f32 volume, coordinates from inside to a few pixels outside the
    plane: 5e-6, the bound tests/test_corr_pallas.py holds the Pallas
    kernels to (same products, summed in another order)."""
    ref, kernel = PAIRS[name]
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((1, 3, 6, 8, 10, 12)).astype(np.float32)
    coords = rng.uniform(-2, 13, (1, 3, 6, 8, 2)).astype(np.float32)
    got = ref(torch.from_numpy(vol), torch.from_numpy(coords)).numpy()
    want = _pallas(kernel, jnp.asarray(vol), jnp.asarray(coords))
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=5e-6)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_reference_matches_pallas_bf16_volume(name):
    """bf16 volume: both widen it to f32 before any arithmetic, so they
    agree as in f32; 0.05 is the file's bound against the f32 lookup."""
    ref, kernel = PAIRS[name]
    rng = np.random.default_rng(3)
    vol = rng.standard_normal((1, 2, 4, 8, 10, 12)).astype(np.float32)
    coords = rng.uniform(0, 11, (1, 2, 4, 8, 2)).astype(np.float32)
    got = ref(torch.from_numpy(vol).to(torch.bfloat16),
              torch.from_numpy(coords))
    assert got.dtype == torch.float32
    want = _pallas(kernel, jnp.asarray(vol).astype(jnp.bfloat16),
                   jnp.asarray(coords))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-6, rtol=5e-6)
    full = np.asarray(jcorr.lookup_level(jnp.asarray(vol),
                                         jnp.asarray(coords), radius=3))
    np.testing.assert_allclose(got.numpy(), full, atol=0.05, rtol=0.05)


@pytest.mark.parametrize("name", sorted(PAIRS))
def test_reference_far_out_of_bounds_is_zero(name):
    ref, kernel = PAIRS[name]
    vol = np.ones((1, 1, 2, 3, 6, 6), np.float32)
    coords = np.full((1, 1, 2, 3, 2), -50.0, np.float32)
    got = ref(torch.from_numpy(vol), torch.from_numpy(coords)).numpy()
    np.testing.assert_array_equal(got, 0.0)
    np.testing.assert_array_equal(
        _pallas(kernel, jnp.asarray(vol), jnp.asarray(coords)), 0.0)


@pytest.mark.parametrize("seed", [0, 1])
def test_backward_reference_matches_jax_grad(seed):
    """The backward's plain version vs jax.grad of the JAX lookup
    (`take_along_axis` form) for a random cotangent: 1e-5 absolute on
    unit-scale gradients (four products per element, summed in another
    order)."""
    rng = np.random.default_rng(seed)
    shape = (1, 3, 5, 7, 9, 11)
    vol = rng.standard_normal(shape).astype(np.float32)
    coords = rng.uniform(-3, 13, shape[:4] + (2,)).astype(np.float32)
    coords[0, 0, 0, :2] = -1e4
    g = rng.standard_normal(shape[:4] + (49,)).astype(np.float32)

    def f(v):
        return jnp.sum(jcorr.lookup_level(v, jnp.asarray(coords), 3)
                       * jnp.asarray(g))

    want = np.asarray(jax.grad(f)(jnp.asarray(vol)))
    got = tcorr.lookup_level_backward_reference(
        torch.from_numpy(g), torch.from_numpy(coords), 9, 11).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("impl", ["level", "level_v2"])
def test_lookup_level_function_gradient(impl):
    """`lookup_level` through the autograd.Function on CPU tensors: its
    value is the plain forward, its gradient the plain backward, which is
    autograd's gradient of the plain forward (1e-5, summation order); no
    kernel launch is counted; coordinates that ask for a gradient raise."""
    rng = np.random.default_rng(5)
    shape = (2, 2, 4, 5, 6, 7)
    vol = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    coords = torch.from_numpy(
        rng.uniform(-3, 9, shape[:4] + (2,)).astype(np.float32))
    g = torch.from_numpy(
        rng.standard_normal(shape[:4] + (49,)).astype(np.float32))
    ref = PAIRS[impl][0]

    tcorr.reset_launch_counts()
    v = vol.clone().requires_grad_(True)
    out = tcorr.lookup_level(v, coords, impl=impl)
    np.testing.assert_array_equal(out.detach().numpy(),
                                  ref(vol, coords).numpy())
    out.backward(g)
    v2 = vol.clone().requires_grad_(True)
    auto, = torch.autograd.grad(ref(v2, coords), v2, g)
    np.testing.assert_allclose(v.grad.numpy(), auto.numpy(), atol=1e-5,
                               rtol=1e-5)
    assert not any(tcorr.launch_counts().values())
    with pytest.raises(ValueError, match="coords"):
        tcorr.lookup_level(v, coords.clone().requires_grad_(True), impl=impl)


def test_set_lookup_impl_routes_lookup_pyramid():
    """`set_lookup_impl` selects the route of `lookup_pyramid`; the three
    routes agree (1e-5: two operation orders) and unknown names raise;
    the wrappers refuse CPU tensors instead of falling back."""
    rng = np.random.default_rng(6)
    vol = torch.from_numpy(
        rng.standard_normal((1, 2, 8, 8, 8, 8)).astype(np.float32))
    coords = torch.from_numpy(
        rng.uniform(-1, 8, (1, 2, 8, 8, 2)).astype(np.float32))
    pyr = tcorr.build_pyramid(vol)
    want = np.asarray(jcorr.lookup_pyramid(
        jcorr.build_pyramid(jnp.asarray(vol.numpy())),
        jnp.asarray(coords.numpy())))
    assert tcorr.lookup_impl() == "level"
    try:
        for name in tcorr.LOOKUP_IMPLS:
            tcorr.set_lookup_impl(name)
            assert tcorr.lookup_impl() == name
            got = tcorr.lookup_pyramid(pyr, coords).numpy()
            np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)
        with pytest.raises(ValueError, match="unknown lookup impl"):
            tcorr.set_lookup_impl("onehot")
    finally:
        tcorr.set_lookup_impl("level")
    for fn in (tcorr.lookup_level_cuda, tcorr.lookup_level_v2_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(vol, coords)
    with pytest.raises(ValueError, match="CUDA"):
        tcorr.lookup_level_backward_cuda(
            torch.zeros(1, 2, 8, 8, 49), coords, 8, 8)


def test_degenerate_levels_give_zero_taps():
    """Tiny training pyramids reach zero-size levels: taps and gradient
    are zeros of the right shape."""
    vol = torch.zeros((1, 2, 3, 3, 0, 0), requires_grad=True)
    coords = torch.zeros((1, 2, 3, 3, 2))
    for impl in ("level", "level_v2"):
        out = tcorr.lookup_level(vol, coords, impl=impl)
        assert out.shape == (1, 2, 3, 3, 49) and not out.any()
    g = tcorr.lookup_level_backward_reference(
        torch.ones(1, 2, 3, 3, 49), coords, 0, 0)
    assert g.shape == (1, 2, 3, 3, 0, 0)
