"""RGB-D input with convex upsampling in the PyTorch port vs the JAX
package: 10 frames of the port's textured box at 96×128 with their exact
depth maps (`tests/torch_port_common.box_seq`), `upsample=True`, f32
network, warmup 5, every frame through the filter, shipped weights.

Staged: before each stage the JAX state is copied into the port, so every
stage is compared on identical inputs (the pattern of
tests/test_torch_runtime.py): the boot graph and each keyframe step
(poses 5e-4, disparities 1e-2 as for mono), two global-BA passes, the
fill (1e-4); after each, the sensor disparities and the convex-upsampled
`disps_up` (1e-4).  Live: both packages run on their own; keyframe count
and timestamps are equal and poses stay within the bounds measured by
`tests/torch_live_sensitivity.py --mode rgbd`.
"""

import numpy as np
import pytest
import torch
from torch_port_common import box_seq, run_staged_and_live, widen_onehot

from droid_slam_tpu_torch.runtime.state import disp_from_depth


@pytest.fixture(scope="module")
def rec():
    """One staged-and-live run, on one thread (the port's CPU result
    depends on the thread count, tests/test_torch_slam.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    mp = pytest.MonkeyPatch()
    widen_onehot(mp)
    try:
        yield run_staged_and_live("rgbd")
    finally:
        mp.undo()
        torch.set_num_threads(n)


def _stages(rec):
    return [rec["boot"]] + rec["steps"] + rec["ba"]


def _close(stage, pose_tol=5e-4, disp_tol=1e-2):
    j, t = stage["jax"], stage["port"]
    assert t["counter"] == j["counter"]
    np.testing.assert_allclose(t["poses"], j["poses"], atol=pose_tol)
    np.testing.assert_allclose(t["disps"], j["disps"], atol=disp_tol)


def test_boot_graph_matches_jax(rec):
    boot = rec["boot"]
    for f, (want, got) in boot["graph"].items():
        np.testing.assert_array_equal(got, want, err_msg=f)
    _close(boot)


def test_keyframe_steps_match_jax(rec):
    assert len(rec["steps"]) == 5
    for stage in rec["steps"]:
        assert sorted(zip(*[e.tolist() for e in stage["edges"][1]])) == \
            sorted(zip(*[e.tolist() for e in stage["edges"][0]]))
        _close(stage)


def test_global_ba_matches_jax(rec):
    for stage in rec["ba"]:
        _close(stage)


def test_sensor_disparities_match_jax(rec):
    """Every keyframe's sensor disparity is its depth map's inverse at the
    pixel centres [3::8, 3::8], equal in both packages, and the prior
    holds the solved disparities near it."""
    _, depths, _ = box_seq("rgbd")
    for stage in _stages(rec):
        j, t = stage["jax"], stage["port"]
        np.testing.assert_array_equal(t["disps_sens"], j["disps_sens"])
        n = t["counter"]
        for k in range(n):
            want = disp_from_depth(depths[int(t["tstamp"][k])], (12, 16))
            np.testing.assert_allclose(t["disps_sens"][k], want, rtol=1e-6)
    last = rec["ba"][-1]["port"]
    n = last["counter"]
    rel = np.abs(last["disps"][:n] / last["disps_sens"][:n] - 1)
    assert np.median(rel) < 0.1, np.median(rel)


def test_disps_up_matches_jax(rec):
    """`disps_up` (8× the 1/8 resolution) after the boot graph, each
    keyframe step and each global-BA pass: written for every keyframe
    with an edge, 1e-4 against the JAX package's."""
    for stage in _stages(rec):
        j, t = stage["jax"], stage["port"]
        n = t["counter"]
        assert t["disps_up"].shape == (n + 1, 96, 128)
        assert np.abs(t["disps_up"][:n]).reshape(n, -1).max(1).min() > 0
        np.testing.assert_allclose(t["disps_up"], j["disps_up"], atol=1e-4)


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
# (tests/torch_live_sensitivity.py --mode rgbd, one CPU thread: keyframe
# poses move by at most 2.1e-6 under intrinsics x (1 +- 1e-7, 1e-6) and
# float64 dense BA, fills by under 5e-5; keyframes 0, 1, 2, 3, 9 in every
# run), and the two baselines are 1.6e-5 (keyframes) and under 5e-5
# (fill) apart: so the live run is held to the staged tolerance of a pose.
LIVE_KEYFRAME_BOUND = 5e-4
LIVE_TRAJ_BOUND = 5e-4
