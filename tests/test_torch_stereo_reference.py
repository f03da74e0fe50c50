"""The port's stereo stages against the benchmark's plain stereo reference
(benchmark/reference/tracking_stereo.py) on the CPU: seeded random
DroidNet weights at the published widths in float32, and 64×96 rectified
pairs of the benchmark's stereo box walk (the smallest size whose feature
map keeps all four correlation levels).

- the rig encoder: fnet on both cameras, context on the left one;
- the fused keyframe step's update operator over a graph with rig edges
  ii == jj, whose targets are frame jj's right camera: it parts from the
  reference by the port's bfloat16 correlation volumes alone (about
  0.02 px a target with these weights); with the left camera in the
  right one's place (a planted fault) the rig edges part by pixels;
- `ops/dba_static.ba` with rig edges against the reference's float64 BA;
- the tracer's counters: `timers.count`, and the update rounds' edges
  counted by both frontends (`edges.active`, `edges.stereo`), nothing
  counted with the tracer off.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from benchmark.generators import stereo_box_walk
from benchmark.lib import loader
from benchmark.reference import dba as ref_dba
from benchmark.reference import tracking_stereo as ref
from benchmark.reference.droidnet import DroidNet as RefNet
from droid_slam_tpu_torch.config import PRESETS
from droid_slam_tpu_torch.lie import se3
from droid_slam_tpu_torch.models.droidnet import (DroidNet, normalize_images,
                                                  random_init)
from droid_slam_tpu_torch.runtime import factor_graph, fused
from droid_slam_tpu_torch.runtime.state import DepthVideo
from droid_slam_tpu_torch.utils import timers

H, W = 64, 96
CPU = torch.device("cpu")
WEIGHT_SEED = 16
# edges of the update-operator test: four frames, three rig edges
II = np.array([0, 1, 1, 2, 2, 3, 1, 0, 3, 2])
JJ = np.array([1, 0, 1, 1, 2, 2, 3, 0, 3, 0])


@pytest.fixture(scope="module")
def rigs():
    p = loader.load_json(os.path.join(loader.HERE, "traffic",
                                      "stereo_fast.json"))
    return stereo_box_walk.make(dict(p, frames=4, step_std=0.05), H, W, 5,
                                CPU)["images"]


@pytest.fixture(scope="module")
def nets():
    port = random_init(DroidNet(), WEIGHT_SEED).eval()
    net = RefNet()
    net.load_state_dict(port.state_dict())
    return port, net.eval()


def test_rig_encoder_agrees(rigs, nets):
    port, net = nets
    with torch.no_grad():
        x = normalize_images(rigs)
        want = (port.fnet(x),) + port.context(x[:, 0])
    got = ref.encode(net, rigs)
    assert got[0].shape == (4, 2, H // 8, W // 8, 128)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, atol=1e-4, rtol=1e-4)
    # the right camera is encoded from the right image
    assert (got[0][:, 0] - got[0][:, 1]).abs().max() > 1e-2


def _keyframe_step(rigs, port):
    """A fused keyframe step over four keyframes of `rigs` with float32
    stores, and the graph state of II, JJ with noisy targets."""
    cfg = dataclasses.replace(PRESETS["euroc"], image_size=(H, W), buffer=8,
                              stereo=True, compute_dtype="float32")
    video = DepthVideo(cfg, CPU)
    st, h, w = video.state, video.fht, video.fwd
    rng = np.random.default_rng(3)
    with torch.no_grad():
        x = normalize_images(rigs)
        st.fmaps = torch.zeros((8, 2, h, w, 128))
        st.fmaps[:4] = port.fnet(x)
        st.nets = torch.zeros((8, h, w, 128))
        st.inps = torch.zeros((8, h, w, 128))
        st.nets[:4], st.inps[:4] = port.context(x[:, 0])
    xi = 0.05 * torch.from_numpy(rng.standard_normal((4, 6))).float()
    xi[0] = 0
    st.poses[:4] = se3.exp(xi)
    st.disps[:4] = torch.from_numpy(0.3 + 0.4 * rng.random((4, h, w))).float()
    st.intrinsics[:4] = torch.tensor([0.9 * W, 0.9 * W, W / 2, H / 2]) / 8
    st.tstamp[:4] = torch.arange(4.0)
    st.damping[:] = torch.from_numpy(1e-3 * rng.random((8, h, w))).float()
    video.counter = 4
    step = fused.KeyframeStep(port, cfg, video)
    g = fused.init_graph_state(step.EA, step.EI, h, w, CPU)
    n = len(II)
    g.ii[:n], g.jj[:n], g.active[:n] = II, JJ, True
    tgt, _ = video.reproject(torch.from_numpy(II), torch.from_numpy(JJ))
    g.target[:n] = tgt + 0.5 * torch.from_numpy(
        rng.standard_normal(tgt.shape)).float()
    g.weight[:n] = torch.from_numpy(rng.random(tgt.shape)).float()
    g.net[:n] = torch.tanh(torch.from_numpy(
        rng.standard_normal((n, h, w, 128))).float())
    return step, g


def _pre(step, g):
    st = step.video.state
    a = torch.as_tensor(np.nonzero(g.active)[0])
    return dict(ii=g.ii.copy(), jj=g.jj.copy(), active=g.active.copy(),
                inac=g.inac.copy(), target=g.target.clone(),
                weight=g.weight.clone(), net=g.net[a].clone(),
                poses=st.poses.clone(), disps=st.disps.clone(),
                damping=st.damping.clone(), disps_sens=st.disps_sens.clone(),
                intrinsics=st.intrinsics.clone(), tstamp=st.tstamp.clone())


@pytest.mark.parametrize("targets", ["right", "left_for_right"])
def test_update_operator_with_rig_edges(monkeypatch, rigs, nets, targets):
    port, net = nets
    if targets == "left_for_right":
        def left(fmaps, ii, jj):
            return fmaps[jj, 0]
        monkeypatch.setattr(factor_graph, "target_fmaps", left)
        monkeypatch.setattr(fused, "target_fmaps", left)
    step, g = _keyframe_step(rigs, port)
    pre = _pre(step, g)
    act = np.nonzero(g.active)[0]
    with torch.no_grad():
        frames, _ = step.update_op(g, act)
    want = ref.update_operator(net, pre, rigs)
    a = torch.as_tensor(act)
    rig = torch.as_tensor(II == JJ)
    flow = (g.target[a] - want[0][a]).abs().mean(dim=(1, 2, 3))
    weight = (g.weight[a] - want[1][a]).abs().mean(dim=(1, 2, 3))
    assert flow[~rig].max() < 0.05 and weight[~rig].max() < 2e-3
    if targets == "right":
        assert flow[rig].max() < 0.05 and weight[rig].max() < 2e-3
        damping = step.video.state.damping[frames]
        assert ((damping - want[2][frames]).norm()
                / want[2][frames].norm()) < 0.02
    else:
        assert flow[rig].min() > 1.0 and weight[rig].min() > 2e-2


def test_static_ba_with_rig_edges_agrees_with_float64():
    from droid_slam_tpu_torch.ops import dba_static

    rng = np.random.default_rng(4)
    buf, h, w = 8, 6, 8
    xi = 0.05 * torch.from_numpy(rng.standard_normal((buf, 6)))
    xi[0] = 0
    poses = se3.exp(xi.float())
    disps = torch.from_numpy(0.5 + 0.5 * rng.random((buf, h, w))).float()
    intr = torch.tensor([[10.0, 10.0, w / 2, h / 2]]).repeat(buf, 1)
    ii = np.array([0, 1, 1, 2, 2, 3, 3, 4, 1, 2, 3, 4, 0, 0])
    jj = np.array([1, 0, 2, 1, 3, 2, 4, 3, 1, 2, 3, 4, 0, 2])
    mask = np.ones(len(ii), bool)
    mask[-1] = False
    coords, _ = ref.reprojection(
        dict(ii=ii, jj=jj, intrinsics=intr), poses, disps, np.arange(len(ii)))
    target = (coords.float() + 0.3 * torch.from_numpy(
        rng.standard_normal(coords.shape)).float())
    weight = torch.from_numpy(rng.random(coords.shape)).float()
    eta = torch.from_numpy(1e-3 + 1e-3 * rng.random((buf, h, w))).float()
    sens = torch.zeros_like(disps)
    t0, t1, P, K = 1, 5, 8, 8
    kx, kmask = ref_dba.build_schur_tables(ii, mask, t0, t1, K)
    idx = dba_static.pack(ii, jj, mask, kx, kmask, t0, t1)
    got = dba_static.ba(poses, disps, sens, intr, target, weight, eta,
                        torch.from_numpy(idx), K=K, P=P, iters=2, lm=1e-4,
                        ep=0.1)
    d = torch.float64
    want = ref_dba.ba(
        poses.to(d), disps.to(d), sens.to(d), intr.to(d), target.to(d),
        weight.to(d), eta.to(d), torch.from_numpy(ii), torch.from_numpy(jj),
        torch.from_numpy(mask), torch.from_numpy(kx),
        torch.from_numpy(kmask), t0, t1, iters=2, lm=1e-4, ep=0.1, P=P)
    assert (want[1] - disps).abs().max() > 1e-2      # the solve moved
    for g, w in zip(got, want):
        torch.testing.assert_close(g.double(), w, atol=1e-4, rtol=1e-4)


@pytest.fixture
def tracer():
    t = timers.Tracer()
    yield t
    t.enable(False)


def test_count_records_only_while_on(tracer):
    tracer.count("edges.active", 5)
    assert tracer.counts() == {}
    tracer.enable()
    tracer.count("edges.active", 5)
    tracer.count("edges.active")
    with tracer.span("round"):
        pass
    assert tracer.counts() == {"edges.active": 6, "round": 1}
    assert set(tracer.summary()) == {"round"}
    assert "edges.active" in tracer.report().split("counter")[1]


@pytest.mark.parametrize("fused_step", [True, False])
def test_rounds_count_their_rig_edges(fused_step):
    """24 pairs of a fast walk at 96×128 with the shipped weights; the
    tracer on from the 13th, after the boot."""
    from droid_slam_tpu_torch.runtime.slam import Droid

    p = loader.load_json(os.path.join(loader.HERE, "traffic",
                                      "stereo_fast.json"))
    walk = stereo_box_walk.make(dict(p, frames=24, step_std=0.3), 96, 128,
                                7, CPU)
    cfg = dataclasses.replace(PRESETS["euroc"], image_size=(96, 128),
                              buffer=32, stereo=True, warmup=6,
                              compute_dtype="float32", fused=fused_step)
    droid = Droid(cfg, weights_path=os.path.join(
        loader.ROOT, "weights", "droid_synth.npz"), device="cpu")
    timers.reset()
    try:
        for t in range(24):
            if t == 12:
                assert timers.counts() == {}
                timers.enable()
            droid.track(float(t), walk["images"][t].numpy(),
                        intrinsics=walk["intrinsics"])
        counts = timers.counts()
    finally:
        timers.enable(False)
        timers.reset()
    assert counts.get("keyframe.round" if fused_step else "graph.update_op")
    assert 0 < counts["edges.stereo"] < counts["edges.active"]
