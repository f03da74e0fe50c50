"""Warmup of the PyTorch port vs the JAX package on tests/fixtures/tiny_seq
(96×128, f32 network, shipped weights): the motion filter at its default
threshold, and every round of the boot factor graph started from the JAX
state.

The boot rounds are compared one at a time: before each round the JAX
poses, disparities, damping and per-edge GRU state / targets / weights are
copied into the port, so a round's error is its own and does not compound.
Tolerances (measured maxima ~2.5-4x below): poses 2e-5; targets 5e-4
pixels, weights 1e-3 and GRU state 2e-3, from f32 convolutions that sum
in another order over 3×3×384-wide reductions; disparities 5e-3, because
the first solves of the boot meet a few pixels with a learned damping near
1e-9 and almost no data term, where two f32 Schur solves differ by up to
~1e-3 (each is that far from a float64 solve); the later rounds agree to
~3e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import WEIGHTS, tiny_seq, widen_onehot


def _droids(**kw):
    from droid_slam_tpu.config import SLAMConfig as JC
    from droid_slam_tpu.runtime.slam import Droid as JD
    from droid_slam_tpu_torch.config import SLAMConfig as TC
    from droid_slam_tpu_torch.runtime.slam import Droid as TD

    kw = dict(dict(image_size=(96, 128), buffer=32, compute_dtype="float32"),
              **kw)
    return (JD(JC(**kw), weights_path=WEIGHTS),
            TD(TC(**kw), weights_path=WEIGHTS, device="cpu"), JC(**kw),
            TC(**kw))


def _t(a):
    return torch.from_numpy(np.array(a, dtype=np.float32))


def test_motion_filter_matches_jax():
    """Default threshold (2.4): the same frames pass, and the gate's mean
    flow magnitude agrees to 1e-4 relative on identical inputs (f32
    encoders and update operator)."""
    imgs, intr = tiny_seq()
    jd, td, _, _ = _droids(warmup=64)        # warmup never reached
    assert td.filter.thresh == 2.4
    passed = []
    for k, im in enumerate(imgs):
        jd.track(float(k), im, intrinsics=intr)
        passed.append(td.track(float(k), im, intrinsics=intr))
        assert td.video.counter == jd.video.counter
    n = jd.video.counter
    assert 1 < n == sum(passed) < len(imgs)
    np.testing.assert_array_equal(td.video.state.tstamp[:n].numpy(),
                                  np.asarray(jd.video.state.tstamp[:n]))

    jf = jd.filter
    for k in range(1, len(imgs)):
        fmap = jf._encode(jf.params, jnp.asarray(imgs[k])[None])
        args = (jf.fmap[0], fmap[0], jf.knet, jf.kinp)
        want = float(jf._delta(jf.params, *args))
        got = float(td.filter.delta(*[_t(a) for a in args]))
        np.testing.assert_allclose(got, want, rtol=1e-4)


def test_boot_rounds_match_jax(monkeypatch):
    widen_onehot(monkeypatch)
    from droid_slam_tpu.runtime.frontend import Frontend as JF
    from droid_slam_tpu_torch.runtime.frontend import Frontend as TF

    imgs, intr = tiny_seq()
    # warmup never reached while the 5 boot frames are appended
    jd, td, jc, tc = _droids(warmup=64, filter_thresh=0.0)
    for k in range(5):
        jd.track(float(k), imgs[k], intrinsics=intr)
        td.track(float(k), imgs[k], intrinsics=intr)
    js, ts = jd.video.state, td.video.state
    for f in ("tstamp", "poses", "disps", "disps_sens", "intrinsics",
              "fmaps", "nets", "inps", "damping"):
        getattr(ts, f).copy_(_t(getattr(js, f).astype(jnp.float32)))

    jg = JF(jd.net, jd.params, jd.video, jc).graph
    tg = TF(td.net, td.video, tc).graph

    def one_round():
        js, ts = jd.video.state, td.video.state
        for f in ("poses", "disps", "damping"):
            getattr(ts, f).copy_(_t(getattr(js, f)))
        tg.target.copy_(_t(jg.target))
        tg.weight.copy_(_t(jg.weight))
        tg.net_state.copy_(_t(jg.net_state))
        jg.update(1, use_inactive=True)
        tg.update(1, use_inactive=True)
        js, ts = jd.video.state, td.video.state
        s = jg.slots
        for name, got, want, atol in [
                ("poses", ts.poses[:6], js.poses[:6], 2e-5),
                ("disps", ts.disps[:6], js.disps[:6], 5e-3),
                ("target", tg.target[s], np.asarray(jg.target)[s], 5e-4),
                ("weight", tg.weight[s], np.asarray(jg.weight)[s], 1e-3),
                ("net", tg.net_state[s], np.asarray(jg.net_state)[s], 2e-3)]:
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       atol=atol, err_msg=name)

    jg.add_neighborhood_factors(0, 5, r=3)
    tg.add_neighborhood_factors(0, 5, r=3)
    assert tg.slots.tolist() == jg.slots.tolist()
    for _ in range(8):
        one_round()
    jg.add_proximity_factors(0, 0, rad=2, nms=2, thresh=jc.frontend_thresh,
                             remove=False)
    tg.add_proximity_factors(0, 0, rad=2, nms=2, thresh=tc.frontend_thresh,
                             remove=False)
    assert (tg.ii.tolist(), tg.jj.tolist(), tg.slots.tolist()) == (
        jg.ii.tolist(), jg.jj.tolist(), jg.slots.tolist())
    for _ in range(8):
        one_round()


@pytest.mark.parametrize("n_evict", [0, 2])
def test_boot_rm_factors_store(n_evict):
    """Removing boot edges archives them in the inactive store in order,
    as the JAX graph does before the fused frontend adopts it."""
    jd, td, _, _ = _droids(warmup=64)
    from droid_slam_tpu.runtime.factor_graph import FactorGraph as JG
    from droid_slam_tpu_torch.runtime.factor_graph import FactorGraph as TG

    for d in (jd, td):
        d.video.counter = 6
    jg = JG(jd.video, jd.net, jd.params, max_factors=8)
    tg = TG(td.video, td.net, max_factors=8)
    for g in (jg, tg):
        g.add_neighborhood_factors(0, 6, r=2)
        if n_evict:
            g.age = np.arange(g.n) % 3
            g.add_factors([5, 0], [0, 5], remove=True)
        g.rm_factors(g.ii < 2, store=True)
    for f in ("ii", "jj", "age", "slots", "ii_inac", "jj_inac"):
        assert getattr(tg, f).tolist() == getattr(jg, f).tolist(), f
