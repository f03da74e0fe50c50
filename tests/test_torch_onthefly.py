"""The keyframe step's on-the-fly correlation at a width where it blocks
its queries, with stereo edges: the port's `edge_correlation`
(runtime/factor_graph.py) against the JAX fused frontend's branch
(droid_slam_tpu/runtime/fused.py, update round without cached volumes).

Level 0 is 32x48 = 1536 query pixels, above the 1024 where the blocking
applies, in blocks of 512; 8 edges, 2 of them ii == jj (those correlate
the left camera with the right one), C = 128 bf16 features pooled into a
4-level pyramid.  Both packages build each block's volume as an f32
matmul rounded to bf16; the JAX one-hot lookup is widened to f32, as the
port's lookup computes.  Tolerance: a volume entry that the two matmuls,
summing in different orders, round to neighbouring bf16 values moves a
tap by at most one bf16 ulp of the largest entry (2^-7 of it), and such
taps are under 1%; every other tap agrees to 1e-4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.ops import corr as jcorr
from droid_slam_tpu.ops.gathers import take_rows
from droid_slam_tpu.runtime import state as jstate
from droid_slam_tpu_torch.runtime.factor_graph import edge_correlation
from torch_port_common import widen_onehot

BUF, RIG, H, W, C = 6, 2, 32, 48, 128
II = np.array([0, 1, 2, 3, 4, 2, 5, 3])
JJ = np.array([1, 0, 2, 4, 3, 5, 5, 1])          # two ii == jj edges


def jax_branch(fmaps, ii, jj, coords, pixel_chunk):
    """The JAX update round's on-the-fly correlation, stage for stage."""
    fmap_pyr = jstate._fmap_pyramids(fmaps)
    ii_a, jj_a = jnp.asarray(ii, jnp.int32), jnp.asarray(jj, jnp.int32)
    f1 = take_rows(fmap_pyr[0], RIG * ii_a).astype(jnp.float32) / 4.0
    cam2 = RIG * jj_a + (ii_a == jj_a).astype(jnp.int32) * (RIG - 1)
    f2 = [take_rows(p, cam2).astype(jnp.float32) / 4.0 for p in fmap_pyr]
    return jcorr.alt_lookup_pyramid(f1, f2, coords, pixel_chunk=pixel_chunk)


@pytest.mark.parametrize("pixel_chunk", [512, 0])
def test_edge_correlation_matches_jax_at_blocking_width(monkeypatch,
                                                        pixel_chunk):
    widen_onehot(monkeypatch)
    rng = np.random.default_rng(11)
    fmaps = torch.from_numpy(rng.standard_normal(
        (BUF, RIG, H, W, C)).astype(np.float32)).to(torch.bfloat16)
    gy, gx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    coords = (np.stack([gx, gy], -1)[None]
              + rng.normal(0, 3, (len(II), H, W, 2))).astype(np.float32)
    coords[:, ::5, ::7] += 40.0                     # some windows outside

    got = edge_correlation(fmaps, torch.from_numpy(II),
                           torch.from_numpy(JJ), torch.from_numpy(coords),
                           pixel_chunk).numpy()
    want = np.asarray(jax_branch(
        jnp.asarray(fmaps.float().numpy()).astype(jnp.bfloat16), II, JJ,
        jnp.asarray(coords), pixel_chunk))
    assert got.shape == want.shape == (len(II), H, W, 4 * 49)

    # the largest level-0 volume entry bounds one bf16 rounding step
    f = fmaps.float() / 4.0
    cam = torch.from_numpy((II == JJ).astype(np.int64))
    vol = torch.einsum("ehwc,eyxc->ehwyx", f[II, 0], f[JJ, cam])
    ulp = float(vol.abs().max()) * 2.0 ** -7
    err = np.abs(got - want)
    assert err.max() <= ulp, (err.max(), ulp)
    assert np.mean(err > 1e-4) < 0.01
    # the ii == jj edges read the right camera: their taps differ from a
    # left-left correlation
    left = edge_correlation(fmaps[:, :1].expand(-1, RIG, -1, -1, -1),
                            torch.from_numpy(II), torch.from_numpy(JJ),
                            torch.from_numpy(coords), pixel_chunk).numpy()
    self_edges = II == JJ
    np.testing.assert_array_equal(left[~self_edges], got[~self_edges])
    assert np.abs(left[self_edges] - got[self_edges]).max() > 0.1
