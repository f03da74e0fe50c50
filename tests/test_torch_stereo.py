"""Stereo input in the PyTorch port vs the JAX package: 10 stereo pairs of
the port's textured box at 96×128 (`tests/torch_port_common.box_seq`, the
right camera 0.1 along the left one's x axis), f32 network, warmup 5,
every frame through the filter, shipped weights.

Staged: before each stage the JAX state is copied into the port, so every
stage is compared on identical inputs (the pattern of
tests/test_torch_runtime.py): the boot graph and each keyframe step (edge
set with its ii == jj stereo edges; poses 5e-4, disparities 1e-2 as for
mono), two global-BA passes, the fill (1e-4).  Live: both packages run on
their own; keyframe count and timestamps are equal and poses stay within
the bounds measured by `tests/torch_live_sensitivity.py --mode stereo`.
Also the stereo edge volumes against the JAX package's.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import WEIGHTS, run_staged_and_live, widen_onehot

from droid_slam_tpu.runtime import fused as jfused
from droid_slam_tpu.runtime import state as jstate
from droid_slam_tpu_torch.ops import corr as tcorr
from droid_slam_tpu_torch.runtime import fused as tfused


@pytest.fixture(scope="module")
def rec():
    """One staged-and-live run, on one thread (the port's CPU result
    depends on the thread count, tests/test_torch_slam.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    widen_onehot(mp)
    try:
        yield run_staged_and_live("stereo")
    finally:
        mp.undo()
        torch.set_num_threads(n)


def _edges(e):
    return sorted(zip(e[0].tolist(), e[1].tolist()))


def _close(stage, pose_tol=5e-4, disp_tol=1e-2):
    j, t = stage["jax"], stage["port"]
    assert t["counter"] == j["counter"]
    np.testing.assert_allclose(t["poses"], j["poses"], atol=pose_tol)
    np.testing.assert_allclose(t["disps"], j["disps"], atol=disp_tol)


def test_boot_graph_matches_jax(rec):
    """The warmup bootstrap (filter, neighbourhood and proximity edges, 16
    rounds) run by both from the same frames: the same adopted graph, with
    a stereo edge for every keyframe the bootstrap keeps edges of (those
    from warmup - 4 on)."""
    boot = rec["boot"]
    for f, (want, got) in boot["graph"].items():
        np.testing.assert_array_equal(got, want, err_msg=f)
    ii, jj = boot["edges"][1]
    n = boot["port"]["counter"]
    assert set(ii[ii == jj].tolist()) == set(range(n - 4, n))
    _close(boot)


def test_keyframe_steps_match_jax(rec):
    assert len(rec["steps"]) == 5
    for stage in rec["steps"]:
        assert _edges(stage["edges"][1]) == _edges(stage["edges"][0])
        ii, jj = stage["edges"][1]
        assert (ii == jj).any()
        _close(stage)


def test_global_ba_matches_jax(rec):
    for stage in rec["ba"]:
        _close(stage)


@pytest.mark.parametrize("fill", ["fill", "fill_batched"])
def test_fill_matches_jax(rec, fill):
    """The port's fill in one batch, and in three batches of 4 (each
    batch reuses the buffer slots of the one before), against the JAX
    package's in one batch."""
    want, got = rec[fill]
    assert got.shape == (10, 7)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_live_run_matches_jax(rec):
    (ts, kp), (jts, jkp) = rec["live_keyframes"], rec["jax_keyframes"]
    np.testing.assert_array_equal(ts, jts)
    np.testing.assert_allclose(kp, jkp, atol=LIVE_KEYFRAME_BOUND)
    want, got = rec["live_traj"]
    assert got.shape == (10, 7) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=LIVE_TRAJ_BOUND)


# bounds of the live comparison.  Each package's own spread here is tiny
# (tests/torch_live_sensitivity.py --mode stereo, one CPU thread:
# keyframe poses move by at most 6.6e-6 under intrinsics x (1 +- 1e-7,
# 1e-6) and float64 dense BA, fills by under 5e-5; keyframes 0, 1, 2, 3, 9
# in every run), and the two baselines are 2.9e-5 (keyframes) and 1e-4
# (fill) apart: so the live run is held to the staged tolerance of a pose.
LIVE_KEYFRAME_BOUND = 5e-4
LIVE_TRAJ_BOUND = 5e-4


def test_stereo_edge_volumes_match_jax():
    """The cached volume pyramid with stereo edges (ii == jj reads the
    right camera) against the JAX package's `make_edge_volumes(stereo=
    True)`: at most one bf16 ulp apart, on under 1% of the entries (two
    matmuls that sum in other orders, tests/test_torch_corr.py); near zero,
    where the two f32 sums may cancel differently, 1e-5 (the f32 rounding
    of a sum of 128 products of this size)."""
    rng = np.random.default_rng(13)
    n, h, w, C = 4, 8, 16, 128
    fmaps = rng.standard_normal((n, 2, h, w, C)).astype(np.float32)
    ii = np.array([0, 1, 1, 2, 3, 2, 0, 3])
    jj = np.array([0, 0, 1, 2, 3, 1, 2, 2])
    E = len(ii)
    fm = torch.from_numpy(fmaps).to(torch.bfloat16)
    got = tfused.edge_volumes(fm, torch.from_numpy(ii), torch.from_numpy(jj))
    g = SimpleNamespace(ii=jnp.asarray(ii), jj=jnp.asarray(jj))
    pyr = jstate._fmap_pyramids(
        jnp.asarray(fm.float().numpy()).astype(jnp.bfloat16))
    want = jfused.make_edge_volumes(SimpleNamespace(stereo=True), E, h,
                                    w)(g, pyr)
    assert len(got) == len(want) == tcorr.NUM_LEVELS
    for l, (a, b) in enumerate(zip(got, want)):
        a = a.float().numpy().reshape(E * h * w, h >> l, w >> l)
        b = np.asarray(b.astype(jnp.float32))
        err = np.abs(a - b)
        ulp = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b)) + 1e-5
        assert (err <= ulp).all(), (err - ulp).max()
        assert np.mean(err > 0) < 0.01
    # a stereo edge differs from the same edge read on the left camera
    mono = tfused.edge_volumes(fm[:, :1], torch.from_numpy(ii),
                               torch.from_numpy(jj))
    assert not torch.equal(mono[0][0], got[0][0])
    assert torch.equal(mono[0][1], got[0][1])


def test_stereo_motion_filter_matches_jax():
    """The motion filter on stereo pairs with depth, warmup never reached:
    the same frames pass; each keyframe holds both cameras' features
    (f32 encoders, stored in bf16: one bf16 ulp, or 1e-3 near zero), the
    context features of the left camera and the sensor disparity of its
    depth map (equal)."""
    from droid_slam_tpu.config import SLAMConfig as JC
    from droid_slam_tpu.runtime.slam import Droid as JD
    from droid_slam_tpu_torch.config import SLAMConfig as TC
    from droid_slam_tpu_torch.data.synthetic import render_stereo_box_scene
    from droid_slam_tpu_torch.runtime.slam import Droid as TD

    sc = render_stereo_box_scene(6, 96, 128, seed=5, motion_scale=0.2)
    intr = sc["intrinsics"][0]
    kw = dict(image_size=(96, 128), buffer=16, compute_dtype="float32",
              stereo=True, warmup=64, filter_thresh=1.0)
    jd = JD(JC(**kw), weights_path=WEIGHTS)
    td = TD(TC(**kw), weights_path=WEIGHTS, device="cpu")
    for k in range(6):
        im, dep = sc["images"][k], sc["depths"][k]
        jd.track(float(k), im, depth=dep, intrinsics=intr)
        td.track(float(k), im, depth=dep, intrinsics=intr)
        assert td.video.counter == jd.video.counter
    n = jd.video.counter
    assert n > 2
    js, ts = jd.video.state, td.video.state
    np.testing.assert_array_equal(ts.tstamp[:n].numpy(),
                                  np.asarray(js.tstamp[:n]))
    np.testing.assert_array_equal(ts.disps_sens[:n].numpy(),
                                  np.asarray(js.disps_sens[:n]))
    a = ts.fmaps[:n].float().numpy()
    b = np.asarray(js.fmaps[:n].astype(jnp.float32))
    assert a.shape == b.shape == (n, 2, 12, 16, 128)
    assert not np.array_equal(a[:, 0], a[:, 1])
    tol = 2.0 ** -7 * np.maximum(np.abs(a), np.abs(b)) + 1e-3
    assert (np.abs(a - b) <= tol).all()
    for f in ("nets", "inps"):
        np.testing.assert_allclose(
            getattr(ts, f)[:n].float().numpy(),
            np.asarray(getattr(js, f)[:n].astype(jnp.float32)), atol=2e-3)
