"""Map export of the port (runtime/visualization.py) against the JAX
package's, and session snapshots (runtime/snapshot.py).

Export: the same keyframe state (the port's textured box with its exact
depths, perturbed, 10 keyframes of which 8 are written) goes to both
packages' `depth_filter` and `export_point_cloud`.  Agreement counts and
the PLY's point count must be equal; the points agree to 2e-4 (the
files print 4 decimals) and their colours exactly.

Snapshots: a Droid saved during warmup or after its frontend booted and
restored into a fresh Droid continues exactly as the original does (one
thread, where every run of the port is identical; tolerance 0).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.runtime import visualization as jvis
from droid_slam_tpu_torch.lie import se3 as tse3
from droid_slam_tpu_torch.runtime import visualization as tvis
from torch_port_common import TINY, WEIGHTS, tiny_seq

BUF, N, H, W = 10, 8, 96, 128


@pytest.fixture(scope="module")
def keyframe_state():
    """BUF-slot buffers of N written keyframes: w2c poses, inverse depths
    at the pixel centres (noisy), intrinsics at 1/8, images."""
    from droid_slam_tpu_torch.data.synthetic import render_box_scene

    sc = render_box_scene(N, H, W, seed=5, motion_scale=0.12)
    rng = np.random.default_rng(0)
    poses = np.tile(np.float32([0, 0, 0, 0, 0, 0, 1]), (BUF, 1))
    poses[:N] = tse3.inv(torch.from_numpy(sc["poses_c2w"])).numpy()
    disps = np.ones((BUF, H // 8, W // 8), np.float32)
    disps[:N] = 1.0 / sc["depths"][:, 3::8, 3::8]
    disps[:N] *= rng.uniform(0.98, 1.02, disps[:N].shape).astype(np.float32)
    intr = (sc["intrinsics"][0] / 8.0).astype(np.float32)
    images = np.zeros((BUF, H, W, 3), np.uint8)
    images[:N] = sc["images"]
    return poses, disps, intr, images


def test_depth_filter_counts_equal_jax(keyframe_state):
    poses, disps, intr, _ = keyframe_state
    inds = np.arange(N)
    thresh = (0.01 * disps[:N].mean(axis=(1, 2))).astype(np.float32)
    want = np.asarray(jvis.depth_filter(
        jnp.asarray(poses), jnp.asarray(disps), jnp.asarray(intr),
        jnp.asarray(inds), jnp.asarray(thresh)))
    got = tvis.depth_filter(torch.from_numpy(poses), torch.from_numpy(disps),
                            torch.from_numpy(intr), torch.from_numpy(inds),
                            torch.from_numpy(thresh)).numpy()
    assert 0 < want.mean() < 6          # neither all nor none agree
    np.testing.assert_array_equal(got, want)


def _read_ply(path):
    with open(path) as f:
        lines = f.read().splitlines()
    n = int(lines[2].split()[-1])
    body = np.array([line.split() for line in lines[10:]], np.float64)
    assert lines[9] == "end_header" and len(body) == n
    return n, body.reshape(n, 6)


def test_export_point_cloud_equals_jax(keyframe_state, tmp_path):
    poses, disps, intr, images = keyframe_state
    intrs = np.tile(intr, (BUF, 1))
    jvideo = types.SimpleNamespace(counter=N, state=types.SimpleNamespace(
        poses=jnp.asarray(poses), disps=jnp.asarray(disps),
        intrinsics=jnp.asarray(intrs), images=jnp.asarray(images)))
    tvideo = types.SimpleNamespace(counter=N, state=types.SimpleNamespace(
        poses=torch.from_numpy(poses), disps=torch.from_numpy(disps),
        intrinsics=torch.from_numpy(intrs),
        colors=torch.from_numpy(images[:, 3::8, 3::8].copy())))
    for kw in ({}, dict(filter_thresh=0.02, min_count=1)):
        n_j = jvis.export_point_cloud(jvideo, str(tmp_path / "j.ply"), **kw)
        n_t = tvis.export_point_cloud(tvideo, str(tmp_path / "t.ply"), **kw)
        assert n_t == n_j > 0
        _, pj = _read_ply(tmp_path / "j.ply")
        _, pt = _read_ply(tmp_path / "t.ply")
        np.testing.assert_allclose(pt[:, :3], pj[:, :3], atol=2e-4)
        np.testing.assert_array_equal(pt[:, 3:], pj[:, 3:])


def test_iproj_points_match_jax(keyframe_state):
    from droid_slam_tpu.lie import se3 as jse3

    poses, disps, intr, _ = keyframe_state
    want = np.asarray(jvis.iproj_points(jse3.inv(jnp.asarray(poses[:N])),
                                        jnp.asarray(disps[:N]),
                                        jnp.asarray(intr)))
    got = tvis.iproj_points(tse3.inv(torch.from_numpy(poses[:N])),
                            torch.from_numpy(disps[:N]),
                            torch.from_numpy(intr)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


@pytest.fixture()
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("save_at", [3, 7])
def test_snapshot_round_trip_continues_identically(tmp_path, one_thread,
                                                   save_at):
    """Save after `save_at` frames (3: during warmup, 7: after the boot at
    frame 5), restore into a fresh Droid, then track the remaining frames
    with both: the keyframe map and the graph are identical throughout."""
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.runtime.slam import Droid
    from droid_slam_tpu_torch.runtime.snapshot import (load_session,
                                                        save_session)

    imgs, intr = tiny_seq()
    cfg = SLAMConfig(**TINY)
    a = Droid(cfg, weights_path=WEIGHTS, device="cpu")
    for k in range(save_at):
        a.track(float(k), imgs[k], intrinsics=intr)
    path = save_session(str(tmp_path / "session.npz"), a)
    b = load_session(path, Droid(cfg, weights_path=WEIGHTS, device="cpu"))
    assert b.frontend.is_initialized == a.frontend.is_initialized
    for k in range(save_at, len(imgs)):
        assert (a.track(float(k), imgs[k], intrinsics=intr)
                == b.track(float(k), imgs[k], intrinsics=intr))
        assert b.video.counter == a.video.counter
        for f in ("tstamp", "poses", "disps", "colors", "fmaps"):
            torch.testing.assert_close(getattr(b.video.state, f),
                                       getattr(a.video.state, f), rtol=0,
                                       atol=0)
        np.testing.assert_array_equal(b.frontend.g.ii, a.frontend.g.ii)
        np.testing.assert_array_equal(b.frontend.g.active,
                                      a.frontend.g.active)
    assert a.frontend.is_initialized
    stream = [(float(k), im, intr) for k, im in enumerate(imgs)]
    np.testing.assert_array_equal(
        b.terminate(iter(stream), backend_steps=(2, 2)),
        a.terminate(iter(stream), backend_steps=(2, 2)))
    with pytest.raises(ValueError, match="terminate"):
        save_session(str(tmp_path / "late.npz"), a)
