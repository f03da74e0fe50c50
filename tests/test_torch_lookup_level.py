"""The training path's lookups: each plain PyTorch version against the
Pallas kernel it stands for (run in interpret mode, as
tests/test_corr_pallas.py runs them), the one-call pyramid version against
its levels and the JAX pyramid lookup, the backward against jax.grad of
the JAX lookup, and the routing of `lookup_level` / `lookup_pyramid`."""

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


def _mk_pyramid(seed, lead, h2, w2, levels, dtype=torch.float32):
    """`levels` 6-D levels (plane sizes halved, floored) and level-0 coords
    with border windows and a few far-out queries."""
    rng = np.random.default_rng(seed)
    pyr = [torch.from_numpy(rng.standard_normal(
        lead + (h2 >> l, w2 >> l)).astype(np.float32)).to(dtype)
        for l in range(levels)]
    coords = np.stack([rng.uniform(-5, w2 + 5, lead),
                       rng.uniform(-5, h2 + 5, lead)], -1).astype(np.float32)
    coords.reshape(-1, 2)[::13] = -1e4
    return pyr, torch.from_numpy(coords)


# (leading shape, h2, w2, levels): one level and four; odd plane sizes
# (7x10 halves to 3x5); query counts that are not a multiple of the four
# queries a warp of the kernel serves
LEVEL_PYRAMIDS = [((1, 2, 6, 8), 24, 32, 4), ((1, 3, 3, 5), 7, 10, 2),
                  ((2, 1, 1, 3), 3, 5, 1), ((1, 1, 5, 7), 15, 20, 3)]


@pytest.mark.parametrize("case", LEVEL_PYRAMIDS)
def test_pyramid_reference_matches_pallas_and_jax(case):
    """The plain pyramid version, level by level against
    `lookup_level_pallas` in interpret mode and as a whole against the JAX
    package's `lookup_pyramid`: 5e-6 on f32 volumes (same products, summed
    in another order)."""
    lead, h2, w2, levels = case
    pyr, coords = _mk_pyramid(h2 + levels, lead, h2, w2, levels)
    got = tcorr.lookup_pyramid_level_reference(pyr, coords).numpy()
    assert got.shape == lead + (49 * levels,)
    for l, vol in enumerate(pyr):
        want = _pallas(corr_pallas.lookup_level_pallas,
                       jnp.asarray(vol.numpy()),
                       jnp.asarray(coords.numpy() / np.float32(2 ** l)))
        np.testing.assert_allclose(got[..., 49 * l:49 * (l + 1)], want,
                                   atol=5e-6, rtol=5e-6)
    want = np.asarray(jcorr.lookup_pyramid(
        [jnp.asarray(v.numpy()) for v in pyr], jnp.asarray(coords.numpy())))
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=5e-6)


@pytest.mark.parametrize("case", LEVEL_PYRAMIDS)
def test_pyramid_equals_levels_concatenated(case):
    """`lookup_pyramid` under "level" equals the per-level lookups at
    coords / 2^l concatenated, bit for bit, and so does its gradient: the
    backward runs once per level on that level's 49 channels."""
    lead, h2, w2, levels = case
    pyr, coords = _mk_pyramid(h2 + levels + 1, lead, h2, w2, levels)
    g = torch.from_numpy(np.random.default_rng(0).standard_normal(
        lead + (49 * levels,)).astype(np.float32))
    a = [v.clone().requires_grad_(True) for v in pyr]
    b = [v.clone().requires_grad_(True) for v in pyr]
    got = tcorr.lookup_pyramid(a, coords, impl="level")
    want = torch.cat([tcorr.lookup_level(v, coords / 2 ** l, impl="level")
                      for l, v in enumerate(b)], dim=-1)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  want.detach().numpy())
    got.backward(g)
    want.backward(g)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.grad.numpy(), y.grad.numpy())


@pytest.mark.parametrize("case", LEVEL_PYRAMIDS)
def test_pyramid_v2_reference_matches_pallas_v2(case):
    """The plain separable pyramid version, level by level against
    `lookup_level_pallas_v2` in interpret mode and as a whole against the
    JAX package's `lookup_pyramid`: 5e-6 on f32 volumes; its one-level form
    is its level 0, bit for bit."""
    lead, h2, w2, levels = case
    pyr, coords = _mk_pyramid(h2 + levels + 2, lead, h2, w2, levels)
    got = tcorr.lookup_pyramid_level_v2_reference(pyr, coords).numpy()
    assert got.shape == lead + (49 * levels,)
    for l, vol in enumerate(pyr):
        want = _pallas(corr_pallas.lookup_level_pallas_v2,
                       jnp.asarray(vol.numpy()),
                       jnp.asarray(coords.numpy() / np.float32(2 ** l)))
        np.testing.assert_allclose(got[..., 49 * l:49 * (l + 1)], want,
                                   atol=5e-6, rtol=5e-6)
    want = np.asarray(jcorr.lookup_pyramid(
        [jnp.asarray(v.numpy()) for v in pyr], jnp.asarray(coords.numpy())))
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=5e-6)
    np.testing.assert_array_equal(
        tcorr.lookup_level_v2_reference(pyr[0], coords).numpy(),
        got[..., :49])


@pytest.mark.parametrize("case", LEVEL_PYRAMIDS)
def test_pyramid_v2_equals_levels_concatenated(case):
    """`lookup_pyramid` under "level_v2" is one call for the whole pyramid
    and equals the per-level lookups at coords / 2^l concatenated, bit for
    bit, gradients included."""
    lead, h2, w2, levels = case
    pyr, coords = _mk_pyramid(h2 + levels + 3, lead, h2, w2, levels)
    g = torch.from_numpy(np.random.default_rng(2).standard_normal(
        lead + (49 * levels,)).astype(np.float32))
    a = [v.clone().requires_grad_(True) for v in pyr]
    b = [v.clone().requires_grad_(True) for v in pyr]
    got = tcorr.lookup_pyramid(a, coords, impl="level_v2")
    want = torch.cat([tcorr.lookup_level(v, coords / 2 ** l,
                                         impl="level_v2")
                      for l, v in enumerate(b)], dim=-1)
    np.testing.assert_array_equal(got.detach().numpy(),
                                  want.detach().numpy())
    got.backward(g)
    want.backward(g)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.grad.numpy(), y.grad.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_pyramid_v2_gradient_matches_jax_grad(seed):
    """The gradient of `lookup_pyramid(impl="level_v2")` with respect to
    every level vs jax.grad of the JAX package's `lookup_pyramid` for a
    random cotangent: 1e-5 absolute on unit-scale gradients (other
    summation order)."""
    pyr, coords = _mk_pyramid(20 + seed, (1, 2, 4, 6), 16, 20, 4)
    g = np.random.default_rng(seed).standard_normal(
        (1, 2, 4, 6, 196)).astype(np.float32)

    def f(levels):
        return jnp.sum(jcorr.lookup_pyramid(levels,
                                            jnp.asarray(coords.numpy()))
                       * jnp.asarray(g))

    want = jax.grad(f)([jnp.asarray(v.numpy()) for v in pyr])
    a = [v.clone().requires_grad_(True) for v in pyr]
    tcorr.lookup_pyramid(a, coords, impl="level_v2").backward(
        torch.from_numpy(g))
    for x, y in zip(a, want):
        np.testing.assert_allclose(x.grad.numpy(), np.asarray(y), atol=1e-5,
                                   rtol=1e-5)


def test_pyramid_function_gradient_matches_autograd():
    """The pyramid autograd.Function on CPU tensors: its gradient is
    autograd's gradient of the plain pyramid forward (1e-5, summation
    order), levels that ask for no gradient get none, a bf16 pyramid gets
    bf16 gradients, and no kernel launch is counted."""
    pyr, coords = _mk_pyramid(9, (1, 2, 4, 6), 12, 16, 4)
    g = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 2, 4, 6, 196)).astype(np.float32))
    tcorr.reset_launch_counts()
    a = [v.clone().requires_grad_(l != 2) for l, v in enumerate(pyr)]
    tcorr.lookup_pyramid(a, coords, impl="level").backward(g)
    b = [v.clone().requires_grad_(True) for v in pyr]
    auto = torch.autograd.grad(
        tcorr.lookup_pyramid_level_reference(b, coords), b, g)
    for l, (x, y) in enumerate(zip(a, auto)):
        if l == 2:
            assert x.grad is None
        else:
            np.testing.assert_allclose(x.grad.numpy(), y.numpy(), atol=1e-5,
                                       rtol=1e-5)
    h = [v.to(torch.bfloat16).requires_grad_(True) for v in pyr]
    tcorr.lookup_pyramid(h, coords, impl="level").backward(g)
    assert all(v.grad.dtype == torch.bfloat16 for v in h)
    assert not any(tcorr.launch_counts().values())
    with pytest.raises(ValueError, match="coords"):
        tcorr.lookup_pyramid(a, coords.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="CUDA"):
        tcorr.lookup_pyramid_level_cuda(pyr, coords)


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
    for fn in (tcorr.lookup_pyramid_level_cuda,
               tcorr.lookup_pyramid_level_v2_cuda):
        with pytest.raises(ValueError, match="CUDA"):
            fn(pyr, coords)
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
