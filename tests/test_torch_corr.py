"""Correlation lookups of the PyTorch port vs the JAX package.

`lookup_pyramid_flat_reference` is the plain version of the serving
lookup kernel (query-major planes, up to four levels in one call); it is
held against the TPU kernel it replaces (`lookup_flat_pallas_v3`, run in
interpret mode on the query-last transpose of the same volume) at 5e-6 on
f32 volumes — the bound the JAX package pins its own kernel to.  Both
compute the same f32 arithmetic, so the slack only covers the
interpret-mode masked sums.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.ops import corr as jcorr
from droid_slam_tpu.ops import corr_pallas
from droid_slam_tpu.runtime import fused as jfused
from droid_slam_tpu.runtime import state as jstate
from droid_slam_tpu_torch.ops import corr as tcorr
from droid_slam_tpu_torch.runtime import fused as tfused
from torch_port_common import widen_onehot

TIGHT = dict(atol=5e-6, rtol=5e-6)


def _mk(seed, E=3, HW=200, h2=10, w2=12):
    """Query-major planes (E, HW, h2, w2) and coords (E, HW, 2) reaching a
    few pixels outside the plane."""
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((E, HW, h2, w2)).astype(np.float32)
    coords = np.stack([rng.uniform(-4, w2 + 4, (E, HW)),
                       rng.uniform(-4, h2 + 4, (E, HW))], -1).astype(
        np.float32)
    return vol, coords


def _pallas_v3(vol, coords):
    """The TPU kernel on the query-last transpose of (E, HW, h2, w2)."""
    return np.asarray(corr_pallas.lookup_flat_pallas_v3(
        jnp.asarray(vol).transpose(0, 2, 3, 1), jnp.asarray(coords),
        interpret=True))


def _mk_pyramid(seed, E, HW, h2, w2, levels, dtype=np.float32):
    """`levels` query-major levels (plane sizes halved, floored) and
    level-0 coords with border windows and a few far-out queries."""
    rng = np.random.default_rng(seed)
    vols = [rng.standard_normal((E, HW, h2 >> l, w2 >> l)).astype(dtype)
            for l in range(levels)]
    coords = np.stack([rng.uniform(-5, w2 + 5, (E, HW)),
                       rng.uniform(-5, h2 + 5, (E, HW))], -1).astype(
        np.float32)
    coords[:, ::17] = -1e4
    return vols, coords


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_matches_pallas_v3(seed):
    vol, coords = _mk(seed)
    got = tcorr.lookup_pyramid_flat_reference([torch.from_numpy(vol)],
                                              torch.from_numpy(coords))
    np.testing.assert_allclose(got.numpy(), _pallas_v3(vol, coords), **TIGHT)


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_matches_onehot_f32(seed):
    vol, coords = _mk(seed)
    E, HW = coords.shape[:2]
    got = tcorr.lookup_pyramid_flat_reference([torch.from_numpy(vol)],
                                              torch.from_numpy(coords))
    want = jcorr.lookup_level_onehot_flat(
        jnp.asarray(vol.reshape(E * HW, *vol.shape[2:])),
        jnp.asarray(coords.reshape(E * HW, 2)))
    np.testing.assert_allclose(got.numpy().reshape(E * HW, -1),
                               np.asarray(want), **TIGHT)


# (E, HW, h2, w2, levels): one level and four; the odd plane sizes of the
# 240x320 pyramid's small levels (7x10, 3x5); query counts that are not a
# multiple of the four queries a warp of the kernel serves
PYRAMID_CASES = [(2, 130, 30, 40, 4), (3, 37, 7, 10, 2), (1, 5, 3, 5, 1),
                 (2, 63, 15, 20, 3)]


@pytest.mark.parametrize("case", PYRAMID_CASES)
def test_pyramid_reference_matches_pallas_v3_and_jax(case):
    """The plain pyramid version, level by level, against the TPU kernel
    in interpret mode and against the JAX package's `lookup_pyramid_flat`
    (one-hot matmuls), 5e-6 on f32 volumes: same products, summed in
    another order."""
    E, HW, h2, w2, levels = case
    vols, coords = _mk_pyramid(sum(case), E, HW, h2, w2, levels)
    got = tcorr.lookup_pyramid_flat(
        [torch.from_numpy(v) for v in vols], torch.from_numpy(coords)).numpy()
    assert got.shape == (E, HW, 49 * levels)
    for l, v in enumerate(vols):
        np.testing.assert_allclose(
            got[..., 49 * l:49 * (l + 1)],
            _pallas_v3(v, coords / np.float32(2 ** l)), **TIGHT)
    want = jcorr.lookup_pyramid_flat(
        [jnp.asarray(v.reshape((E * HW,) + v.shape[2:])) for v in vols],
        jnp.asarray(coords.reshape(E * HW, 2)))
    np.testing.assert_allclose(got.reshape(E * HW, -1), np.asarray(want),
                               **TIGHT)


@pytest.mark.parametrize("case", PYRAMID_CASES)
def test_pyramid_equals_levels_concatenated(case):
    """One pyramid call equals the per-level lookups at coords / 2^l,
    concatenated, bit for bit (the kernel scales by the exact 2^-l)."""
    E, HW, h2, w2, levels = case
    vols, coords = _mk_pyramid(sum(case) + 1, E, HW, h2, w2, levels)
    vols = [torch.from_numpy(v) for v in vols]
    c = torch.from_numpy(coords)
    got = tcorr.lookup_pyramid_flat(vols, c)
    want = torch.cat([tcorr.lookup_flat(v, c / 2 ** l)
                      for l, v in enumerate(vols)], dim=-1)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    np.testing.assert_array_equal(
        got.numpy(), tcorr.lookup_pyramid_flat(vols, c * 0.5 * 2.0).numpy())


def test_pyramid_bf16_volume_is_widened_exactly():
    """A bf16 pyramid is widened to f32 before any arithmetic: identical
    to the lookup of the widened pyramid."""
    vols, coords = _mk_pyramid(11, 2, 50, 15, 20, 4)
    vb = [torch.from_numpy(v).to(torch.bfloat16) for v in vols]
    c = torch.from_numpy(coords)
    np.testing.assert_array_equal(
        tcorr.lookup_pyramid_flat(vb, c).numpy(),
        tcorr.lookup_pyramid_flat([v.float() for v in vb], c).numpy())


def test_pyramid_argument_checks():
    vols, coords = _mk_pyramid(3, 2, 20, 8, 8, 2)
    vols = [torch.from_numpy(v) for v in vols]
    c = torch.from_numpy(coords)
    with pytest.raises(ValueError, match="levels"):
        tcorr.lookup_pyramid_flat([], c)
    with pytest.raises(ValueError, match="levels"):
        tcorr.lookup_pyramid_flat(vols * 3, c)
    with pytest.raises(ValueError, match="share"):
        tcorr.lookup_pyramid_flat([vols[0], vols[1][:1]], c)
    with pytest.raises(ValueError, match="share"):
        tcorr.lookup_pyramid_flat([vols[0], vols[1].double()], c)
    with pytest.raises(ValueError, match="coords"):
        tcorr.lookup_pyramid_flat(vols, c[:1])
    with pytest.raises(TypeError):
        tcorr.lookup_pyramid_flat(vols, c.double())
    with pytest.raises(TypeError):
        tcorr.lookup_pyramid_flat([v.double() for v in vols], c)
    with pytest.raises(ValueError, match="planes"):
        tcorr.lookup_pyramid_flat([v[0] for v in vols], c)


def test_far_out_of_bounds_zero():
    vol = torch.ones((1, 130, 8, 8))
    coords = torch.full((1, 130, 2), -77.0)
    np.testing.assert_array_equal(
        tcorr.lookup_flat(vol, coords).numpy(), 0.0)
    coords = torch.full((1, 130, 2), 3e9)      # past the int clamp
    np.testing.assert_array_equal(
        tcorr.lookup_flat(vol, coords).numpy(), 0.0)


def test_no_flat_index_wraparound():
    """x just past the right edge must not alias the next row."""
    E, HW, h2, w2 = 1, 128, 6, 8
    v = np.zeros((E, HW, h2, w2), np.float32)
    v[0, :, 3, :] = 7.0
    coords = np.zeros((E, HW, 2), np.float32)
    coords[..., 0] = w2 + 2.0
    coords[..., 1] = 2.0
    got = tcorr.lookup_flat(torch.from_numpy(v), torch.from_numpy(coords))
    ref = jcorr.lookup_level_onehot_flat(
        jnp.asarray(v.reshape(E * HW, h2, w2)),
        jnp.asarray(coords.reshape(E * HW, 2)))
    np.testing.assert_allclose(got.numpy().reshape(E * HW, -1),
                               np.asarray(ref), atol=5e-6)
    np.testing.assert_allclose(got.numpy(), _pallas_v3(v, coords), atol=5e-6)


def test_prepadded_matches_unpadded():
    """Planes padded with zero rows and columns, and edges that hold more
    planes than they have queries (a padded query axis), give identical
    taps."""
    rng = np.random.default_rng(8)
    E, HW, h2, w2, HWp = 2, 140, 12, 20, 256
    v = rng.standard_normal((E, HW, h2, w2)).astype(np.float32)
    vp = np.zeros((E, HWp, h2 + 3, w2 + 4), np.float32)
    vp[:, :HW, :h2, :w2] = v
    coords = torch.from_numpy(
        rng.uniform(-2, w2 + 2, (E, HW, 2)).astype(np.float32))
    a = tcorr.lookup_flat(torch.from_numpy(vp), coords)
    b = tcorr.lookup_flat(torch.from_numpy(v), coords)
    np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_bf16_volume():
    """A bf16 volume is widened to f32 first: identical to the lookup of
    the widened volume, and to the TPU kernel on the same bf16 input."""
    vol, coords = _mk(4)
    vb = torch.from_numpy(vol).to(torch.bfloat16)
    c = torch.from_numpy(coords)
    a = tcorr.lookup_flat(vb, c)
    b = tcorr.lookup_flat(vb.float(), c)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    want = corr_pallas.lookup_flat_pallas_v3(
        jnp.asarray(vb.float().numpy()).astype(jnp.bfloat16).transpose(
            0, 2, 3, 1), jnp.asarray(coords), interpret=True)
    np.testing.assert_allclose(a.numpy(), np.asarray(want), **TIGHT)


def test_query_major_strides_match_query_last():
    """Query-major planes that are a strided view (here the transpose of a
    query-last volume) give the taps of their contiguous copy, and the
    planes of all edges flattened into one edge give the same taps."""
    vol, coords = _mk(5, E=2, HW=96)
    E, HW, h2, w2 = vol.shape
    c = torch.from_numpy(coords)
    qmajor = tcorr.lookup_flat(torch.from_numpy(vol), c)
    qlast = torch.from_numpy(np.ascontiguousarray(vol.transpose(0, 2, 3, 1)))
    view = tcorr.lookup_flat(qlast.permute(0, 3, 1, 2), c)
    np.testing.assert_array_equal(view.numpy(), qmajor.numpy())
    flat = tcorr.lookup_flat(
        torch.from_numpy(vol.reshape(1, E * HW, h2, w2)),
        c.reshape(1, E * HW, 2))
    np.testing.assert_array_equal(flat.numpy().reshape(E, HW, -1),
                                  qmajor.numpy())


def test_radius_other_than_3_raises():
    vol, coords = _mk(0, E=1, HW=4)
    with pytest.raises(ValueError):
        tcorr.lookup_flat(torch.from_numpy(vol), torch.from_numpy(coords),
                          radius=2)


def test_cpu_tensors_take_the_plain_version():
    """A CPU tensor goes to the plain version without a launch; the
    kernel's wrapper refuses CPU tensors instead of falling back."""
    vol, coords = _mk(6, E=2, HW=40)
    v, c = torch.from_numpy(vol), torch.from_numpy(coords)
    tcorr.reset_launch_counts()
    np.testing.assert_array_equal(
        tcorr.lookup_flat(v, c).numpy(),
        tcorr.lookup_pyramid_flat_reference([v], c).numpy())
    counts = tcorr.launch_counts()
    assert "corr_lookup" in counts and not any(counts.values())
    with pytest.raises(ValueError, match="CUDA"):
        tcorr.lookup_pyramid_flat_cuda([v], c)


def test_edge_volumes_query_major_match_jax():
    """The cached volume pyramid, query-major (E, h·w, h2, w2) bf16,
    against the per-query planes of the JAX package's
    `make_edge_volumes`.  Both round an f32 matmul to bf16; the two
    matmuls sum in different orders, so an entry may land on the
    neighbouring bf16 value: at most one bf16 ulp (the spacing at a value
    v is at most 2^-7 |v|), on under 1% of the entries."""
    rng = np.random.default_rng(12)
    n, h, w, C = 5, 8, 16, 128
    fmaps = rng.standard_normal((n, 1, h, w, C)).astype(np.float32)
    ii = np.array([0, 1, 2, 4, 3, 0, 2, 1])
    jj = np.array([1, 0, 4, 2, 3, 2, 0, 4])
    E = len(ii)
    fm = torch.from_numpy(fmaps).to(torch.bfloat16)
    got = tfused.edge_volumes(fm, torch.from_numpy(ii), torch.from_numpy(jj))
    g = SimpleNamespace(ii=jnp.asarray(ii), jj=jnp.asarray(jj))
    pyr = jstate._fmap_pyramids(
        jnp.asarray(fm.float().numpy()).astype(jnp.bfloat16))
    want = jfused.make_edge_volumes(SimpleNamespace(stereo=False), E, h,
                                    w)(g, pyr)
    assert len(got) == len(want) == tcorr.NUM_LEVELS
    for l, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.bfloat16 and a.is_contiguous()
        assert a.shape == (E, h * w, h >> l, w >> l)
        a = a.float().numpy().reshape(E * h * w, h >> l, w >> l)
        b = np.asarray(b.astype(jnp.float32))
        err = np.abs(a - b)
        ulp = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b))
        assert (err <= ulp).all(), (err - ulp).max()
        assert np.mean(err > 0) < 0.01


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


# (E, h, w, C, pixel_chunk): the last case has a level 0 above 1024
# pixels, where the chunk applies (the port blocks every level by query
# pixels, the JAX package only the large level: same volumes)
@pytest.mark.parametrize("case", [(3, 12, 16, 64, 0), (3, 12, 16, 64, 37),
                                  (1, 32, 40, 16, 500)])
def test_alt_lookup_pyramid_matches_jax(monkeypatch, case):
    """On-the-fly correlation.  Both round the block volume to bf16 the
    same way; the JAX one-hot lookup then also rounds its weights and
    row sums to bf16, so it is patched to widen the volume to f32 first
    (what the TPU kernel does).  Taps agree to 1e-4 except where the two
    f32 matmuls that build the volume, summing in different orders, round
    an entry to neighbouring bf16 values: under 1% of the taps, each off
    by less than 2e-3 (one bf16 ulp of the volume)."""
    widen_onehot(monkeypatch)
    rng = np.random.default_rng(6)
    E, h, w, C, pixel_chunk = case
    f1, pyr = _feature_pyramid(rng, E, h, w, C)
    coords = rng.uniform(-3, w + 2, (E, h, w, 2)).astype(np.float32)
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
