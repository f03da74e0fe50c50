"""Runtime pieces of the PyTorch port vs the JAX package.

* proximity selection vs the JAX package's native selector;
* the fused frontend's insert / LRU-evict / retire-ring bookkeeping
  (the cases of tests/test_fused.py);
* staged parity of the whole pipeline on tests/fixtures/tiny_seq: each
  keyframe step, backend pass and the trajectory fill start from the JAX
  state copied into the port, so every stage is compared on identical
  inputs.  Poses agree to 5e-4 and disparities to 1e-2: a few pixels have
  a learned damping near 1e-9 and a near-zero data term, so their inverse
  depth is ill-conditioned, and two f32 Gauss-Newton solves that sum in
  another order differ there by a few tenths of a percent of a disparity
  near 10.
"""

import numpy as np
import pytest
import torch
from torch_port_common import (TINY, WEIGHTS, copy_graph, copy_video,
                               tiny_seq, widen_onehot)

from droid_slam_tpu import native
from droid_slam_tpu_torch.runtime import fused as tfused
from droid_slam_tpu_torch.runtime.proximity import select_proximity_edges
from droid_slam_tpu_torch.runtime.state import DepthVideo


@pytest.mark.parametrize("seed,t0,t1,t,rad,nms,maxf", [
    (0, 0, 0, 12, 2, 2, 48), (1, 3, 0, 20, 2, 1, 30), (2, 0, 0, 30, 2, 3, 480),
    (3, 15, 5, 22, 1, 0, 16), (4, 0, 0, 9, 2, 2, 4)])
def test_proximity_matches_native(seed, t0, t1, t, rad, nms, maxf):
    rng = np.random.default_rng(seed)
    d = (rng.random((t - t0, t - t1)) * 30).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = 500.0
    ex_i = rng.integers(0, t, 6)
    ex_j = rng.integers(0, t, 6)
    want = native.select_proximity_edges(d.copy(), t0, t1, t, ex_i, ex_j,
                                         rad, nms, 16.0, maxf, False)
    if want is None:
        pytest.skip("native proximity library unavailable")
    got = select_proximity_edges(d, t0, t1, t, ex_i, ex_j, rad, nms, 16.0,
                                 maxf)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])


class _Video:
    """The state the insert step reads: poses, disps, intrinsics, nets."""

    def __init__(self, h, w, nets):
        cfg = type("C", (), {"buffer": 8, "image_size": (8 * h, 8 * w),
                             "stereo": False, "upsample": False})
        self.video = DepthVideo(cfg, "cpu")
        self.video.state.disps.fill_(1.0)
        self.video.state.intrinsics.copy_(
            torch.tensor([4.0, 4.0, 2.0, 2.0]).expand(8, 4))
        self.video.state.nets.copy_(nets.to(torch.float16))


def test_insert_dedup():
    """Candidates already present must not re-insert; fresh candidates
    take free slots in order and seed their GRU state from nets[ii]."""
    EA, EI, h, w = 16, 8, 4, 4
    g = tfused.init_graph_state(EA, EI, h, w, "cpu")
    g.ii[3], g.jj[3], g.active[3], g.tick = 5, 2, True, 1
    nets = torch.arange(8.0)[:, None, None, None].expand(8, h, w, 128)
    video = _Video(h, w, nets).video
    g2 = tfused.insert_candidates(g, video, [5, 6], [2, 3], max_factors=8)
    act = g2.active
    got = sorted(zip(g2.ii[:EA][act].tolist(), g2.jj[:EA][act].tolist()))
    assert got == [(5, 2), (6, 3)]
    s = int(np.nonzero(act & (g2.ii[:EA] == 6))[0][0])
    assert s == 0                        # first free slot
    assert torch.allclose(g2.net[s], torch.tensor(6.0))
    assert g2.tick == 2 and g2.seq[s] == 1


def test_lru_eviction_order():
    """Over-budget inserts evict oldest-age edges (ties: earliest
    inserted) into the inactive ring."""
    EA, EI, h, w = 8, 8, 2, 2
    g = tfused.init_graph_state(EA, EI, h, w, "cpu")
    g.ii[:3], g.jj[:3] = [1, 2, 3], [4, 5, 6]
    g.age[:3], g.seq[:3] = [5, 5, 1], [0, 1, 2]
    g.active[:3] = True
    g.tick = 3
    video = _Video(h, w, torch.ones(8, h, w, 128)).video
    g2 = tfused.insert_candidates(g, video, [5, 6], [2, 3], max_factors=3)
    act, inac = g2.active, g2.inac
    assert sorted(zip(g2.ii[:EA][act].tolist(),
                      g2.jj[:EA][act].tolist())) == [(3, 6), (5, 2), (6, 3)]
    assert sorted(zip(g2.ii[EA:][inac].tolist(),
                      g2.jj[EA:][inac].tolist())) == [(1, 4), (2, 5)]
    assert g2.ring_ptr == 2
    assert g2.ii[EA] == 1 and g2.ii[EA + 1] == 2


def test_retire_ring_newest_wins():
    """More retirements than ring slots: the ring keeps the newest."""
    EA, EI = 6, 2
    g = tfused.init_graph_state(EA, EI, 1, 1, "cpu")
    g.ii[:5] = np.arange(5)
    g.target[:5] = torch.arange(5.0)[:, None, None, None]
    g.active[:5] = True
    g = tfused.retire(g, g.active.copy())
    assert not g.active.any() and g.inac.all()
    assert sorted(g.ii[EA:].tolist()) == [3, 4]
    assert g.ring_ptr == 5 % EI
    assert g.target[EA + (4 % EI), 0, 0, 0].item() == 4.0


def test_build_kx():
    ii = np.array([7, 2, 9, 3], np.int64)
    mask = np.array([True, True, False, True])
    kx, kmask = tfused.build_kx(ii, mask, 4, 6, 16, 5)
    assert kx[kmask].tolist() == [2, 3, 4, 5, 7]
    kx, kmask = tfused.build_kx(ii, mask, 4, 6, 16, 3)     # truncated
    assert kx.tolist() == [2, 3, 4] and kmask.all()


# ---------------------------------------------------------------------------
# staged pipeline parity
# ---------------------------------------------------------------------------

def _assert_state_close(jd, td):
    n = jd.video.counter
    assert td.video.counter == n
    js, ts = jd.video.state, td.video.state
    np.testing.assert_allclose(ts.poses[:n + 1].numpy(),
                               np.asarray(js.poses[:n + 1]), atol=5e-4)
    np.testing.assert_allclose(ts.disps[:n + 1].numpy(),
                               np.asarray(js.disps[:n + 1]), atol=1e-2)


def test_staged_pipeline_matches_jax(monkeypatch):
    widen_onehot(monkeypatch)
    from droid_slam_tpu.config import SLAMConfig as JC
    from droid_slam_tpu.runtime.slam import Droid as JD
    from droid_slam_tpu_torch.config import SLAMConfig as TC
    from droid_slam_tpu_torch.runtime.slam import Droid as TD

    imgs, intr = tiny_seq()
    jd = JD(JC(**TINY), weights_path=WEIGHTS)
    td = TD(TC(**TINY), weights_path=WEIGHTS, device="cpu")
    for k in range(5):                       # warmup: filter + boot graph
        jd.track(float(k), imgs[k], intrinsics=intr)
        td.track(float(k), imgs[k], intrinsics=intr)
    assert td.frontend.is_initialized and td.video.counter == 5
    jg, tg = jd.frontend.gstate, td.frontend.g       # boot graph adopted
    for f in ("ii", "jj", "age", "seq", "active", "inac"):
        np.testing.assert_array_equal(getattr(tg, f), np.asarray(
            getattr(jg, f)), err_msg=f)
    assert (tg.ring_ptr, tg.tick) == (int(jg.ring_ptr), int(jg.tick))

    for k in range(5, 12):                   # one fused step per frame
        copy_video(jd, td)
        copy_graph(jd, td)
        jd.track(float(k), imgs[k], intrinsics=intr)
        jd._sync()
        td.track(float(k), imgs[k], intrinsics=intr)
        _assert_state_close(jd, td)
        ja, jb = jd.frontend.active_edges()
        ta, tb = td.frontend.active_edges()
        assert sorted(zip(ta.tolist(), tb.tolist())) == sorted(
            zip(ja.tolist(), jb.tolist()))

    for steps in (2, 2):                     # global BA passes
        copy_video(jd, td)
        jd.backend(steps)
        td.backend(steps)
        _assert_state_close(jd, td)

    copy_video(jd, td)
    stream = [(float(k), im, intr) for k, im in enumerate(imgs)]
    want = jd.traj_filler(iter(stream))
    got = td.traj_filler(iter(stream))
    assert got.shape == (12, 7)
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_fused_steps_match_jax_whatever_unused_slots_hold(monkeypatch):
    """Fused keyframe steps from the JAX state, with every edge slot the
    graph state does not hold (free active slots, empty ring slots)
    filled with NaN targets and infinite weights in the port: its
    static-shape BA linearizes every slot and must select those to zero,
    so the steps still match the JAX package's at the staged bounds."""
    widen_onehot(monkeypatch)
    from droid_slam_tpu.config import SLAMConfig as JC
    from droid_slam_tpu.runtime.slam import Droid as JD
    from droid_slam_tpu_torch.config import SLAMConfig as TC
    from droid_slam_tpu_torch.runtime.slam import Droid as TD

    imgs, intr = tiny_seq()
    jd = JD(JC(**TINY), weights_path=WEIGHTS)
    td = TD(TC(**TINY), weights_path=WEIGHTS, device="cpu")
    for k in range(5):
        jd.track(float(k), imgs[k], intrinsics=intr)
        td.track(float(k), imgs[k], intrinsics=intr)
    for k in range(5, 9):
        copy_video(jd, td)
        copy_graph(jd, td)
        g = td.frontend.g
        unused = torch.from_numpy(np.flatnonzero(~g.exist()))
        assert len(unused) > 0
        g.target[unused] = float("nan")
        g.weight[unused] = float("inf")
        jd.track(float(k), imgs[k], intrinsics=intr)
        jd._sync()
        td.track(float(k), imgs[k], intrinsics=intr)
        _assert_state_close(jd, td)
