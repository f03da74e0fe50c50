"""The host-driven frontend of the PyTorch port (`SLAMConfig(fused=False)`,
runtime/frontend.py) against the JAX package's.

* `rm_keyframe` on the same edge lists and keyframe buffers gives the
  same edges, inactive store and shifted slots (exact: it only moves
  rows).
* Each host keyframe step on tests/fixtures/tiny_seq (shipped weights,
  f32 network; proximity, eviction, the rounds, the cull through
  `rm_keyframe`, extrapolation) starts from the JAX `fused=False` state
  copied into the port: keyframe count, `t1` and the active edges equal,
  poses within 5e-4 and disparities within 1e-2 (the bounds of
  tests/test_torch_runtime.py's staged keyframe steps, for the same
  ill-conditioned pixels).
* The port's host path against its own fused path, both driven by a
  ground-truth oracle in place of the update operator, as
  tests/test_fused.py does for the JAX package: the same keyframe
  decisions and edges, poses within 1e-3 and disparities within 1e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import TINY, WEIGHTS, copy_video, tiny_seq, widen_onehot

from droid_slam_tpu_torch.config import SLAMConfig as TC
from droid_slam_tpu_torch.geom import projective
from droid_slam_tpu_torch.lie import se3 as tse3
from droid_slam_tpu_torch.runtime.factor_graph import FactorGraph
from droid_slam_tpu_torch.runtime.frontend import Frontend
from droid_slam_tpu_torch.runtime.fused import FusedFrontend, KeyframeStep
from droid_slam_tpu_torch.runtime.state import DepthVideo

GRAPH_LISTS = ("ii", "jj", "age", "slots", "ii_inac", "jj_inac")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these small problems gain nothing from more,
    and the test run shares its cores between workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _edit_pair(seed):
    """A JAX and a port FactorGraph over the same 8 keyframes (random
    tstamps, poses, disparities), with the same radius-3 neighborhood
    edges, some archived in the inactive store."""
    from droid_slam_tpu.config import SLAMConfig as JC
    from droid_slam_tpu.runtime.factor_graph import FactorGraph as JG
    from droid_slam_tpu.runtime.state import DepthVideo as JV

    rng = np.random.default_rng(seed)
    kw = dict(image_size=(32, 48), buffer=10)
    jv, tv = JV(JC(**kw)), DepthVideo(TC(**kw), "cpu")
    poses = np.tile(np.float32([0, 0, 0, 0, 0, 0, 1]), (10, 1))
    poses[:, :3] = 0.05 * rng.standard_normal((10, 3))
    disps = rng.uniform(0.5, 1.5, (10, 4, 6)).astype(np.float32)
    intr = np.tile(np.float32([6, 6, 3, 2]), (10, 1))
    tstamp = np.arange(10, dtype=np.float32) + 0.5
    jv.state = jv.state.replace(
        poses=jnp.asarray(poses), disps=jnp.asarray(disps),
        intrinsics=jnp.asarray(intr), tstamp=jnp.asarray(tstamp))
    for f, a in (("poses", poses), ("disps", disps), ("intrinsics", intr),
                 ("tstamp", tstamp)):
        getattr(tv.state, f).copy_(torch.from_numpy(a))
    jv.counter = tv.counter = 8
    jg = JG(jv, None, None, max_factors=40)
    tg = FactorGraph(tv, None, max_factors=40)
    for g in (jg, tg):
        g.add_neighborhood_factors(0, 8, r=3)
        g.age = np.arange(g.n) % 4
    # the same rows in both (each package reprojects its own targets)
    t = rng.uniform(0, 6, (jg.E_alloc, 4, 6, 2)).astype(np.float32)
    w = rng.uniform(0, 1, (jg.E_alloc, 4, 6, 2)).astype(np.float32)
    w[rng.random(jg.E_alloc) < 0.5] *= 1e-4
    jg.target, jg.weight = jnp.asarray(t), jnp.asarray(w)
    tg.target.copy_(torch.from_numpy(t))
    tg.weight.copy_(torch.from_numpy(w))
    for g in (jg, tg):
        g.rm_factors(g.ii < 2, store=True)
    return jv, tv, jg, tg


def _assert_graphs_equal(jg, tg):
    for f in GRAPH_LISTS:
        assert getattr(tg, f).tolist() == getattr(jg, f).tolist(), f
    n = len(jg.ii_inac)
    np.testing.assert_array_equal(tg.target_inac[:n].numpy(),
                                  np.asarray(jg.target_inac)[:n])
    np.testing.assert_array_equal(tg.weight_inac[:n].numpy(),
                                  np.asarray(jg.weight_inac)[:n])


@pytest.mark.parametrize("ix", [1, 3, 6])
def test_rm_keyframe_matches_jax(ix):
    jv, tv, jg, tg = _edit_pair(ix)
    _assert_graphs_equal(jg, tg)
    jg.rm_keyframe(ix)
    tg.rm_keyframe(ix)
    _assert_graphs_equal(jg, tg)
    for f in ("tstamp", "poses", "disps"):
        np.testing.assert_array_equal(getattr(tv.state, f).numpy()[:9],
                                      np.asarray(getattr(jv.state, f))[:9])


# ---------------------------------------------------------------------------
# staged host keyframe steps against the JAX package
# ---------------------------------------------------------------------------

def _copy_host_graph(jg, tg):
    """The JAX host graph (edge lists, free slots, slot-indexed stores and
    the inactive store) into the port's."""
    for f in GRAPH_LISTS:
        setattr(tg, f, np.array(getattr(jg, f)).astype(np.int64))
    tg.free = [int(s) for s in jg.free]
    tg.E_alloc = jg.E_alloc
    for f in ("net_state", "target", "weight", "target_inac",
              "weight_inac"):
        a = torch.from_numpy(np.array(getattr(jg, f), np.float32))
        setattr(tg, f, a.to(getattr(tg, f).dtype))


def test_host_keyframe_steps_match_jax(monkeypatch):
    widen_onehot(monkeypatch)
    from droid_slam_tpu.config import SLAMConfig as JC
    from droid_slam_tpu.runtime.slam import Droid as JD
    from droid_slam_tpu_torch.runtime.slam import Droid as TD

    imgs, intr = tiny_seq()
    jd = JD(JC(**TINY, fused=False), weights_path=WEIGHTS)
    td = TD(TC(**TINY, fused=False), weights_path=WEIGHTS, device="cpu")
    assert isinstance(td.frontend, Frontend)
    culls = 0
    # frames 5-8 cull the keyframe before them, frame 9 keeps it
    imgs = imgs[:10]
    for k, im in enumerate(imgs):
        if td.frontend.is_initialized:
            copy_video(jd, td)
            _copy_host_graph(jd.frontend.graph, td.frontend.graph)
            td.frontend.t1 = jd.frontend.t1
        n0 = jd.video.counter
        jd.track(float(k), im, intrinsics=intr)
        td.track(float(k), im, intrinsics=intr)
        n = jd.video.counter
        culls += td.frontend.is_initialized and k >= TINY["warmup"] and \
            n == n0
        assert (td.video.counter, td.frontend.t1) == (n, jd.frontend.t1)
        jgr, tgr = jd.frontend.graph, td.frontend.graph
        assert sorted(zip(tgr.ii.tolist(), tgr.jj.tolist())) == sorted(
            zip(jgr.ii.tolist(), jgr.jj.tolist()))
        assert sorted(zip(tgr.ii_inac.tolist(), tgr.jj_inac.tolist())) == \
            sorted(zip(jgr.ii_inac.tolist(), jgr.jj_inac.tolist()))
        js, ts = jd.video.state, td.video.state
        if k < TINY["warmup"]:
            continue      # appends and the boot (tests/test_torch_boot.py)
        np.testing.assert_allclose(ts.poses[:n + 1].numpy(),
                                   np.asarray(js.poses[:n + 1]), atol=5e-4)
        np.testing.assert_allclose(ts.disps[:n + 1].numpy(),
                                   np.asarray(js.disps[:n + 1]), atol=1e-2)
    assert td.frontend.count == len(imgs) - TINY["warmup"]
    assert culls > 0                         # rm_keyframe ran


# ---------------------------------------------------------------------------
# host path against the fused path, under a ground-truth oracle
# ---------------------------------------------------------------------------

H, W, N_FRAMES = 96, 128, 16
KT = 1.0


ORACLE_CFG = dict(
    image_size=(H, W), buffer=24, warmup=6, filter_thresh=0.0,
    frontend_window=10, frontend_edge_cap=64,
    frontend_pose_cap=32, frontend_depth_cap=32, frontend_thresh=64.0)


@pytest.fixture(scope="module")
def plane_scene():
    from droid_slam_tpu_torch.data.synthetic import render_plane_scene

    return render_plane_scene(N_FRAMES, H, W, seed=3, motion_scale=0.05)


def _oracle(monkeypatch, scene):
    """Replace both frontends' update operator by the ground truth:
    targets are the true reprojections, weights their validity, damping
    1e-4 everywhere."""
    gt_poses = tse3.inv(torch.from_numpy(scene["poses_c2w"]))
    gt_disps = torch.from_numpy(1.0 / scene["depths"][:, 3::8, 3::8])
    intr8 = torch.from_numpy(scene["intrinsics"] / 8.0)

    def truth(ii, jj):
        ii = torch.as_tensor(np.clip(ii, 0, N_FRAMES - 1))
        jj = torch.as_tensor(np.clip(jj, 0, N_FRAMES - 1))
        coords, valid = projective.projective_transform(
            gt_poses[None], gt_disps[None], intr8[None], ii, jj)
        return coords[0], valid[0].expand_as(coords[0])

    def graph_op(self):
        ii, jj, mask = self._edge_arrays()
        s = torch.as_tensor(np.nonzero(mask)[0])
        self.target[s], self.weight[s] = truth(ii[mask], jj[mask])
        self.video.state.damping.fill_(1e-4)

    def step_op(self, g, act, vols=None):
        a = torch.as_tensor(act)
        g.target[a], g.weight[a] = truth(g.ii[act], g.jj[act])
        self.video.state.damping.fill_(1e-4)
        return torch.unique(torch.as_tensor(g.ii[act])), None

    monkeypatch.setattr(FactorGraph, "_run_update_op", graph_op)
    monkeypatch.setattr(KeyframeStep, "update_op", step_op)


def _drive(frontend_cls, scene, keyframe_thresh):
    """Append every frame as a keyframe.  The host frontend runs its
    step on each call; the fused one boots on its call and then runs
    `KeyframeStep` on each new keyframe, as `track_frame` does after its
    append."""
    cfg = TC(**ORACLE_CFG, keyframe_thresh=keyframe_thresh)
    video = DepthVideo(cfg, "cpu")
    frontend = frontend_cls(None, video, cfg)
    h8, w8 = H // 8, W // 8
    intr8 = scene["intrinsics"][0] / 8.0
    for t in range(N_FRAMES):
        video.append(float(t), None, None, None, intr8,
                     torch.zeros((1, h8, w8, 128)),
                     torch.zeros((h8, w8, 128)), torch.zeros((h8, w8, 128)))
        if isinstance(frontend, FusedFrontend) and frontend.is_initialized:
            frontend.t1 += 1
            frontend.g, cull = frontend.step(frontend.g, frontend.t1)
            video.counter -= cull
            frontend.t1 -= cull
        else:
            frontend()
    return frontend, video


@pytest.mark.parametrize("keyframe_thresh,culls", [(0.01, 0), (0.6, None)])
def test_host_path_matches_fused_path(monkeypatch, plane_scene,
                                      keyframe_thresh, culls):
    """keyframe_thresh 0.01 keeps every keyframe, as tests/test_fused.py;
    0.6 culls some of them (6 of 16)."""
    _oracle(monkeypatch, plane_scene)
    f_host, v_host = _drive(Frontend, plane_scene, keyframe_thresh)
    f_fused, v_fused = _drive(FusedFrontend, plane_scene, keyframe_thresh)
    assert f_host.is_initialized and f_fused.is_initialized
    assert v_host.counter == v_fused.counter
    if culls == 0:
        assert v_host.counter == N_FRAMES
    else:
        assert 0 < N_FRAMES - v_host.counter < N_FRAMES - ORACLE_CFG["warmup"]
    assert f_host.t1 == f_fused.t1
    edges = [sorted(zip(*[e.tolist() for e in f.active_edges()]))
             for f in (f_host, f_fused)]
    assert edges[0] == edges[1]
    n = v_host.counter
    np.testing.assert_allclose(v_fused.state.poses[:n].numpy(),
                               v_host.state.poses[:n].numpy(), atol=1e-3)
    np.testing.assert_allclose(v_fused.state.disps[:n].numpy(),
                               v_host.state.disps[:n].numpy(), atol=1e-2)


def test_host_session_round_trip_continues_identically(tmp_path):
    """A `fused=False` Droid saved after the boot (frame 6 of tiny_seq)
    and restored into a fresh one continues exactly as the original
    through frame 9, culls and a kept keyframe (one thread, as the
    module's fixture sets; tolerance 0); a session of the other frontend
    is refused."""
    from droid_slam_tpu_torch.runtime.slam import Droid as TD
    from droid_slam_tpu_torch.runtime.snapshot import (load_session,
                                                        save_session)

    imgs, intr = tiny_seq()
    cfg = TC(**TINY, fused=False)
    a = TD(cfg, weights_path=WEIGHTS, device="cpu")
    for k in range(6):
        a.track(float(k), imgs[k], intrinsics=intr)
    path = save_session(str(tmp_path / "host.npz"), a)
    with pytest.raises(ValueError, match="fused=False"):
        load_session(path, TD(TC(**TINY), weights_path=WEIGHTS,
                              device="cpu"))
    b = load_session(path, TD(cfg, weights_path=WEIGHTS, device="cpu"))
    for k in range(6, 10):
        a.track(float(k), imgs[k], intrinsics=intr)
        b.track(float(k), imgs[k], intrinsics=intr)
        assert (b.video.counter, b.frontend.t1, b.frontend.count) == (
            a.video.counter, a.frontend.t1, a.frontend.count)
        for f in ("poses", "disps"):
            torch.testing.assert_close(getattr(b.video.state, f),
                                       getattr(a.video.state, f),
                                       rtol=0, atol=0)
        np.testing.assert_array_equal(b.frontend.graph.ii,
                                      a.frontend.graph.ii)
