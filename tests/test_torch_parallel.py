"""The distributed global BA of the PyTorch port (parallel/dba.py) against
the JAX package's `make_distributed_ba` and the port's single-device BA.

On tests/test_parallel.py's problem (10 posed frames, radius-3 edges,
noisy poses, exact targets), sharded by source frame over 2 and 8 CPU
shards: the port's shards hold the JAX partition's edges and depth
frames exactly; its poses agree with JAX's dense and compact distributed
solvers and with its own single-device BA to atol 2e-4 / rtol 1e-3, its
disparities to 2e-3 / 2e-2 (the bounds of tests/test_parallel.py: the
shards sum the pose system in another order).  The backend with
`distributed_backend=True` over two CPU shards matches the single-device
backend to 2e-3, as tests/test_parallel.py:128 requires of the JAX one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from droid_slam_tpu.geom import projective as jproj
from droid_slam_tpu.lie import se3 as jse3
from droid_slam_tpu.parallel import dba as jpdba
from droid_slam_tpu_torch.ops import dba as tdba
from droid_slam_tpu_torch.parallel import dba as tpdba
from droid_slam_tpu_torch.parallel.launch import ba_mesh

T0, ITERS, LM, EP, P_CAP = 2, 2, 1e-5, 1e-2, 16
POSE_TOL = dict(atol=2e-4, rtol=1e-3)
DISP_TOL = dict(atol=2e-3, rtol=2e-2)


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these small problems gain nothing from more,
    and the test run shares its cores between workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def problem():
    """tests/test_parallel.py's `problem`, seed 0."""
    rng = np.random.default_rng(0)
    T, BUF, ht, wd = 10, 16, 12, 16
    xs = np.cumsum(0.05 * rng.standard_normal((T, 6)), axis=0)
    xs[0] = 0
    poses_gt = np.tile([0, 0, 0, 0, 0, 0, 1.0], (BUF, 1)).astype(np.float32)
    poses_gt[:T] = np.asarray(jse3.exp(jnp.asarray(xs, jnp.float32)))
    disps_gt = (0.6 + 0.25 * rng.random((BUF, ht, wd))).astype(np.float32)
    intr = np.tile([wd * 1.2, wd * 1.2, wd / 2, ht / 2], (BUF, 1)).astype(
        np.float32)
    ii, jj = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    keep = (np.abs(ii - jj) >= 1) & (np.abs(ii - jj) <= 3)
    ii, jj = ii[keep].astype(np.int32), jj[keep].astype(np.int32)
    target, _ = jproj.projective_transform(
        jnp.asarray(poses_gt)[None], jnp.asarray(disps_gt)[None],
        jnp.asarray(intr)[None], jnp.asarray(ii), jnp.asarray(jj))
    target = np.asarray(target[0])
    noise = 0.02 * rng.standard_normal((BUF, 6)).astype(np.float32)
    noise[:2] = 0
    noise[T:] = 0
    poses0 = np.asarray(jse3.retr(jnp.asarray(poses_gt), jnp.asarray(noise)))
    return dict(poses0=poses0, disps0=np.ones_like(disps_gt), intr=intr,
                ii=ii, jj=jj, target=target, weight=np.ones_like(target),
                eta=1e-4 * np.ones((BUF, ht, wd), np.float32), T=T, BUF=BUF,
                ht=ht, wd=wd)


def _t(a):
    return torch.from_numpy(np.array(a))


def _port_shards(pb, n):
    mask = np.ones(len(pb["ii"]), bool)
    need_e, need_k = tpdba.plan_shard_caps(pb["ii"], mask, T0, pb["T"], n)
    return tpdba.shard_edges_by_frame(pb["ii"], pb["jj"], mask, n, need_e,
                                      need_k, T0, pb["T"])


def _port_distributed(pb, n, shards=None):
    shards = _port_shards(pb, n) if shards is None else shards
    return tpdba.distributed_ba(
        _t(pb["poses0"]), _t(pb["disps0"]),
        torch.zeros((pb["BUF"], pb["ht"], pb["wd"])), _t(pb["intr"]),
        _t(pb["eta"]), _t(pb["target"]), _t(pb["weight"]), shards,
        ["cpu"] * n, T0, pb["T"], iters=ITERS, lm=LM, ep=EP, P=P_CAP)


def _port_single(pb):
    mask = np.ones(len(pb["ii"]), bool)
    kx, km = tdba.build_schur_tables(pb["ii"], mask, T0, pb["T"], 16)
    return tdba.ba(
        _t(pb["poses0"]), _t(pb["disps0"]),
        torch.zeros((pb["BUF"], pb["ht"], pb["wd"])), _t(pb["intr"]),
        _t(pb["target"]), _t(pb["weight"]), _t(pb["eta"]),
        _t(pb["ii"]).long(), _t(pb["jj"]).long(), _t(mask), _t(kx), _t(km),
        T0, pb["T"], iters=ITERS, lm=LM, ep=EP, P=P_CAP)


@pytest.mark.parametrize("n", [2, 8])
def test_shards_match_jax_partition(problem, n):
    pb = problem
    mask = np.ones(len(pb["ii"]), bool)
    need = jpdba.plan_shard_caps(pb["ii"], mask, T0, pb["T"], n)
    assert tpdba.plan_shard_caps(pb["ii"], mask, T0, pb["T"], n) == need[:2]
    want = jpdba.shard_edges_by_frame(
        pb["ii"], pb["jj"], pb["target"], pb["weight"], mask, n, *need,
        T0, pb["T"])
    ii, jj, rows, msk, kx, km = _port_shards(pb, n)
    for got, w in ((ii, want[0]), (jj, want[1]), (msk, want[4]),
                   (kx, want[5]), (km, want[6])):
        np.testing.assert_array_equal(got, w)
    np.testing.assert_array_equal(pb["target"][rows] * msk[..., None, None,
                                                           None], want[2])


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("compact", [False, True])
def test_distributed_ba_matches_jax(problem, n, compact):
    pb = problem
    mask = np.ones(len(pb["ii"]), bool)
    need = jpdba.plan_shard_caps(pb["ii"], mask, T0, pb["T"], n)
    shards = jpdba.shard_edges_by_frame(
        pb["ii"], pb["jj"], pb["target"], pb["weight"], mask, n, *need,
        T0, pb["T"])
    extra, kw = (), {}
    if compact:
        CK = 4
        tabs = jpdba.build_shard_compact_tables(
            shards[0], shards[1], shards[4], shards[5], shards[6], T0,
            pb["T"], CK, P_CAP)
        assert tabs is not None
        extra = (jnp.asarray(tabs[0]), jnp.asarray(tabs[1]))
        kw = dict(compact=True, schur_chunk=CK)
    fn = jpdba.make_distributed_ba(Mesh(np.array(jax.devices()[:n]),
                                        ("ba",)), iters=ITERS, lm=LM,
                                   ep=EP, P_cap=P_CAP, **kw)
    pj, dj = fn(jnp.asarray(pb["poses0"]), jnp.asarray(pb["disps0"]),
                jnp.zeros((pb["BUF"], pb["ht"], pb["wd"])),
                jnp.asarray(pb["intr"]), jnp.asarray(pb["eta"]),
                *[jnp.asarray(s) for s in shards], *extra, T0, pb["T"])
    pt, dt = _port_distributed(pb, n)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), **POSE_TOL)
    np.testing.assert_allclose(dt.numpy(), np.asarray(dj), **DISP_TOL)


@pytest.mark.parametrize("n", [2, 8])
def test_distributed_ba_matches_single_device(problem, n):
    p1, d1 = _port_single(problem)
    pt, dt = _port_distributed(problem, n)
    assert float((pt - torch.from_numpy(problem["poses0"])).abs().max()) \
        > 1e-3                                  # the poses did move
    np.testing.assert_allclose(pt.numpy(), p1.numpy(), **POSE_TOL)
    np.testing.assert_allclose(dt.numpy(), d1.numpy(), **DISP_TOL)


def test_shard_sums_are_the_pose_system(problem, monkeypatch):
    """The shards' pose systems, as `reduce_pose_systems` receives them,
    sum to the single-device H - S and v - vs of the first iteration
    (rtol 1e-4 of the largest entry: f32 sums in another order)."""
    pb = problem
    seen = []
    orig = tpdba.reduce_pose_systems
    monkeypatch.setattr(tpdba, "reduce_pose_systems",
                        lambda parts, dev: seen.append(parts)
                        or orig(parts, dev))
    _port_distributed(pb, 2)
    assert len(seen) == ITERS and len(seen[0]) == 2

    mask = torch.ones(len(pb["ii"]), dtype=torch.bool)
    kx, km = tdba.build_schur_tables(pb["ii"], mask.numpy(), T0, pb["T"], 16)
    prob = tdba.edge_problem(
        _t(pb["ii"]).long(), _t(pb["jj"]).long(), mask, _t(pb["target"]),
        _t(pb["weight"]), _t(kx), _t(km),
        torch.zeros((pb["BUF"], pb["ht"], pb["wd"])), _t(pb["eta"]), T0,
        P_CAP)
    H4, vd, _ = tdba.pose_system(prob, _t(pb["poses0"]), _t(pb["disps0"]),
                                 _t(pb["intr"]))
    for got, want in ((sum(p[0] for p in seen[0]), H4),
                      (sum(p[1] for p in seen[0]), vd)):
        scale = float(want.abs().max())
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   atol=1e-4 * scale)


def test_distributed_ba_repeats(problem):
    a = _port_distributed(problem, 8)
    b = _port_distributed(problem, 8)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_ba_mesh():
    assert ba_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    if not torch.cuda.is_available():
        assert ba_mesh() == []           # every visible card: none here


def test_backend_distributed_matches_single(monkeypatch):
    """`Backend(distributed=True)` over two CPU shards against the
    single-device backend, both driven by a ground-truth oracle in place
    of the update operator (tests/test_parallel.py:128)."""
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.data.synthetic import render_plane_scene
    from droid_slam_tpu_torch.geom import projective
    from droid_slam_tpu_torch.lie import se3
    from droid_slam_tpu_torch.runtime.backend import Backend
    from droid_slam_tpu_torch.runtime.factor_graph import FactorGraph
    from droid_slam_tpu_torch.runtime.state import DepthVideo

    H, W, N = 96, 128, 10
    scene = render_plane_scene(N, H, W, seed=5, motion_scale=0.05)
    gt_poses = se3.inv(torch.from_numpy(scene["poses_c2w"]))
    gt_disps = torch.from_numpy(1.0 / scene["depths"][:, 3::8, 3::8])
    intr8 = torch.from_numpy(scene["intrinsics"] / 8.0)

    def oracle(self):
        ii, jj, mask = self._edge_arrays()
        s = torch.as_tensor(np.nonzero(mask)[0])
        coords, valid = projective.projective_transform(
            gt_poses[None], gt_disps[None], intr8[None],
            torch.as_tensor(np.clip(ii[mask], 0, N - 1)),
            torch.as_tensor(np.clip(jj[mask], 0, N - 1)))
        self.target[s] = coords[0]
        self.weight[s] = valid[0].expand_as(coords[0])
        self.video.state.damping.fill_(1e-4)

    monkeypatch.setattr(FactorGraph, "_run_update_op", oracle)
    seen = []
    orig = tpdba.distributed_ba
    monkeypatch.setattr(tpdba, "distributed_ba",
                        lambda *a, **k: seen.append(1) or orig(*a, **k))

    def run(distributed):
        cfg = SLAMConfig(image_size=(H, W), buffer=16, warmup=6,
                         distributed_backend=distributed)
        video = DepthVideo(cfg, "cpu")
        h8, w8 = H // 8, W // 8
        for t in range(N):
            video.append(float(t), None, None, None,
                         scene["intrinsics"][0] / 8.0,
                         torch.zeros((1, h8, w8, 128)),
                         torch.zeros((h8, w8, 128)),
                         torch.zeros((h8, w8, 128)))
        Backend(None, video, cfg, mesh=["cpu", "cpu"])(steps=2)
        return video.state.poses[:N].numpy()

    p_single = run(False)
    assert not seen
    p_dist = run(True)
    assert len(seen) == 2                    # one sharded BA per sweep
    assert np.all(np.isfinite(p_dist))
    np.testing.assert_allclose(p_dist, p_single, atol=2e-3)
