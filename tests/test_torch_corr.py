"""Correlation lookups of the PyTorch port vs the JAX package.

`lookup_flat_reference` is the plain version of the CUDA lookup kernel;
it is held against the TPU kernel it replaces (`lookup_flat_pallas_v3`,
run in interpret mode) at 5e-6 on f32 volumes — the bound the JAX package
pins its own kernel to.  Both compute the same f32 arithmetic, so the
slack only covers the interpret-mode masked sums.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.ops import corr as jcorr
from droid_slam_tpu.ops import corr_pallas
from droid_slam_tpu_torch.ops import corr as tcorr
from torch_port_common import widen_onehot

TIGHT = dict(atol=5e-6, rtol=5e-6)


def _mk(seed, E=3, HW=200, h2=10, w2=12):
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((E, HW, h2, w2)).astype(np.float32)
    coords = np.stack([rng.uniform(-4, w2 + 4, (E, HW)),
                       rng.uniform(-4, h2 + 4, (E, HW))], -1).astype(
        np.float32)
    return vol, coords


def _qlast(vol):
    """(E, HW, h2, w2) -> contiguous query-last (E, h2, w2, HW)."""
    return torch.from_numpy(np.ascontiguousarray(vol.transpose(0, 2, 3, 1)))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_pallas_v3(seed):
    vol, coords = _mk(seed)
    got = tcorr.lookup_flat_reference(_qlast(vol), torch.from_numpy(coords))
    want = corr_pallas.lookup_flat_pallas_v3(
        jnp.asarray(vol.transpose(0, 2, 3, 1)), jnp.asarray(coords),
        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TIGHT)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_onehot_f32(seed):
    vol, coords = _mk(seed)
    E, HW = coords.shape[:2]
    got = tcorr.lookup_flat_reference(_qlast(vol), torch.from_numpy(coords))
    want = jcorr.lookup_level_onehot_flat(
        jnp.asarray(vol.reshape(E * HW, *vol.shape[2:])),
        jnp.asarray(coords.reshape(E * HW, 2)))
    np.testing.assert_allclose(got.numpy().reshape(E * HW, -1),
                               np.asarray(want), **TIGHT)


def test_far_out_of_bounds_zero():
    vol = torch.ones((1, 8, 8, 130))
    coords = torch.full((1, 130, 2), -77.0)
    np.testing.assert_array_equal(
        tcorr.lookup_flat(vol, coords).numpy(), 0.0)
    coords = torch.full((1, 130, 2), 3e9)      # past the int clamp
    np.testing.assert_array_equal(
        tcorr.lookup_flat(vol, coords).numpy(), 0.0)


def test_no_flat_index_wraparound():
    """x just past the right edge must not alias the next row."""
    E, HW, h2, w2 = 1, 128, 6, 8
    v = np.zeros((E, h2, w2, HW), np.float32)
    v[0, 3, :, :] = 7.0
    coords = np.zeros((E, HW, 2), np.float32)
    coords[..., 0] = w2 + 2.0
    coords[..., 1] = 2.0
    got = tcorr.lookup_flat(torch.from_numpy(v), torch.from_numpy(coords))
    ref = jcorr.lookup_level_onehot_flat(
        jnp.asarray(v.transpose(0, 3, 1, 2).reshape(E * HW, h2, w2)),
        jnp.asarray(coords.reshape(E * HW, 2)))
    np.testing.assert_allclose(got.numpy().reshape(E * HW, -1),
                               np.asarray(ref), atol=5e-6)
    want = corr_pallas.lookup_flat_pallas_v3(
        jnp.asarray(v), jnp.asarray(coords), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6)


def test_prepadded_matches_unpadded():
    """Zero padding of the plane width and extra query columns (the JAX
    builder's born-padded layout) give identical taps."""
    rng = np.random.default_rng(8)
    E, HW, h2, w2, HWp = 2, 140, 12, 20, 256
    v = rng.standard_normal((E, h2, w2, HW)).astype(np.float32)
    vp = np.zeros((E, h2, w2 + 4, HWp), np.float32)
    vp[:, :, :w2, :HW] = v
    coords = torch.from_numpy(
        rng.uniform(-2, w2 + 2, (E, HW, 2)).astype(np.float32))
    a = tcorr.lookup_flat(torch.from_numpy(vp), coords)
    b = tcorr.lookup_flat(torch.from_numpy(v), coords)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_bf16_volume():
    """A bf16 volume is widened to f32 first: identical to the lookup of
    the widened volume, and to the TPU kernel on the same bf16 input."""
    vol, coords = _mk(4)
    vb = _qlast(vol).to(torch.bfloat16)
    c = torch.from_numpy(coords)
    a = tcorr.lookup_flat(vb, c)
    b = tcorr.lookup_flat(vb.float(), c)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = corr_pallas.lookup_flat_pallas_v3(
        jnp.asarray(vb.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(coords), interpret=True)
    np.testing.assert_allclose(a.numpy(), np.asarray(want), **TIGHT)


def test_query_major_strides_match_query_last():
    vol, coords = _mk(5, E=2, HW=96)
    E, HW, h2, w2 = vol.shape
    c = torch.from_numpy(coords)
    qlast = tcorr.lookup_flat(_qlast(vol), c)
    qmajor = tcorr.lookup_flat(
        tcorr.query_major_view(torch.from_numpy(vol)), c)
    np.testing.assert_array_equal(qlast.numpy(), qmajor.numpy())
    # flat (Q, h2, w2) planes as one edge
    flat = tcorr.lookup_flat(
        tcorr.query_major_view(torch.from_numpy(vol.reshape(E * HW, h2, w2))),
        c.reshape(1, E * HW, 2))
    np.testing.assert_array_equal(flat.numpy().reshape(E, HW, -1),
                                  qlast.numpy())


def test_radius_other_than_3_raises():
    vol, coords = _mk(0, E=1, HW=4)
    with pytest.raises(ValueError):
        tcorr.lookup_flat(_qlast(vol), torch.from_numpy(coords), radius=2)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor goes to the plain version without a launch; the
    kernel's wrapper refuses CPU tensors instead of falling back."""
    vol, coords = _mk(6, E=2, HW=40)
    v, c = _qlast(vol), torch.from_numpy(coords)
    tcorr.reset_launch_counts()
    np.testing.assert_array_equal(tcorr.lookup_flat(v, c).numpy(),
                                  tcorr.lookup_flat_reference(v, c).numpy())
    counts = tcorr.launch_counts()
    assert "corr_lookup" in counts and not any(counts.values())
    with pytest.raises(ValueError, match="CUDA"):
        tcorr.lookup_flat_cuda(v, c)


def test_lookup_pyramid_matches_jax():
    """The motion filter's one-edge pyramid (query-major planes)."""
    rng = np.random.default_rng(2)
    h, w, C = 6, 8, 16
    f1 = rng.standard_normal((1, 1, h, w, C)).astype(np.float32)
    f2 = rng.standard_normal((1, 1, h, w, C)).astype(np.float32)
    coords = (rng.uniform(-2, 9, (1, 1, h, w, 2))).astype(np.float32)
    tp = tcorr.build_pyramid(tcorr.corr_volume(torch.from_numpy(f1),
                                               torch.from_numpy(f2)))
    jp = jcorr.build_pyramid(jcorr.corr_volume(jnp.asarray(f1),
                                               jnp.asarray(f2)))
    for a, b in zip(tp, jp):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    got = tcorr.lookup_pyramid(tp, torch.from_numpy(coords))
    want = jcorr.lookup_pyramid(jp, jnp.asarray(coords))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


def _feature_pyramid(rng, E, h, w, C):
    f1 = (rng.standard_normal((E, h, w, C)) / 4).astype(np.float32)
    f2 = rng.standard_normal((E, h, w, C)).astype(np.float32)
    pyr = [f2]
    for _ in range(3):
        x = pyr[-1]
        hh, ww = x.shape[1] // 2 * 2, x.shape[2] // 2 * 2
        pyr.append(x[:, :hh, :ww].reshape(E, hh // 2, 2, ww // 2, 2, C)
                   .mean((2, 4)).astype(np.float32))
    return f1, [p / 4 for p in pyr]


@pytest.mark.parametrize("pixel_chunk", [0, 37])
def test_alt_lookup_pyramid_matches_jax(monkeypatch, pixel_chunk):
    """On-the-fly correlation.  Both round the block volume to bf16 the
    same way; the JAX one-hot lookup then also rounds its weights and
    row sums to bf16, so it is patched to widen the volume to f32 first
    (what the TPU kernel does).  Taps agree to 1e-4 except where the two
    f32 matmuls that build the volume, summing in different orders, round
    an entry to neighbouring bf16 values: under 1% of the taps, each off
    by less than 2e-3 (one bf16 ulp of the volume)."""
    widen_onehot(monkeypatch)
    rng = np.random.default_rng(6)
    E, h, w, C = 3, 12, 16, 64
    f1, pyr = _feature_pyramid(rng, E, h, w, C)
    coords = rng.uniform(-3, 18, (E, h, w, 2)).astype(np.float32)
    got = tcorr.alt_lookup_pyramid(
        torch.from_numpy(f1), [torch.from_numpy(p) for p in pyr],
        torch.from_numpy(coords), pixel_chunk=pixel_chunk)
    want = jcorr.alt_lookup_pyramid(
        jnp.asarray(f1), [jnp.asarray(p) for p in pyr], jnp.asarray(coords),
        pixel_chunk=pixel_chunk)
    err = np.abs(got.numpy() - np.asarray(want))
    assert err.max() < 2e-3, err.max()
    assert np.mean(err > 1e-4) < 0.01


def test_gate_corr_pyramid_matches_jax():
    rng = np.random.default_rng(7)
    E, h, w, C = 1, 12, 16, 32
    f1, pyr = _feature_pyramid(rng, E, h, w, C)
    got = tcorr.gate_corr_pyramid(torch.from_numpy(f1),
                                  [torch.from_numpy(p) for p in pyr])
    want = jcorr.gate_corr_pyramid(jnp.asarray(f1),
                                   [jnp.asarray(p) for p in pyr])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
