"""The port's tracer (droid_slam_tpu_torch/utils/timers.py) on the CPU:
off it records nothing and its sites return one shared null context; on
(after `enable()` or inside a `torch.profiler` session) it records spans
on `time.perf_counter_ns`, with `innermost_at` as the benchmark's
`Spans.innermost_at`; its ring wraps with exact counts; and tracking and
training are bit-equal with it on and off."""

import dataclasses
import os.path as osp
import time

import pytest
import torch

from benchmark.lib.spans import Spans
from droid_slam_tpu_torch.utils import timers

WEIGHTS = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                   "weights", "droid_synth.npz")


@pytest.fixture
def tracer():
    t = timers.Tracer()
    yield t
    t.enable(False)


def test_off_it_records_nothing(tracer):
    assert not tracer.recording()
    assert tracer.span("a") is timers._NULL
    assert tracer.sync_site("b", 3) is timers._NULL
    with tracer.span("a"):
        with tracer.sync_site("b"):
            pass
    assert tracer.spans() == [] and tracer.counts() == {}
    assert tracer.summary() == {} and tracer.innermost_at(0) is None


def test_the_module_tracer_is_off_by_default():
    assert timers.span("a") is timers._NULL
    assert timers.sync_site("a") is timers._NULL


@pytest.mark.parametrize("switch", ["enable", "profiler"])
def test_on_it_records_spans_on_the_host_clock(tracer, switch):
    def work():
        t_before = time.perf_counter_ns()
        with tracer.span("outer"):
            with tracer.sync_site("wait", 2):
                torch.ones(4).sum()
        return t_before, time.perf_counter_ns()

    if switch == "enable":
        tracer.enable()
        a, b = work()
    else:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            assert tracer.recording()
            a, b = work()
        assert not tracer.recording()
    (n1, s1, e1), (n0, s0, e0) = tracer.spans()
    assert (n1, n0) == ("sync.wait", "outer")
    assert a <= s0 <= s1 <= e1 <= e0 <= b
    assert tracer.counts() == {"outer": 1, "sync.wait": 2}
    assert tracer.totals_ns() == {"outer": e0 - s0, "sync.wait": e1 - s1}


def test_a_span_that_outlives_the_recording_is_dropped(tracer):
    """As the window's last draw in the benchmark's training cell, which
    the profiler's stop ends: only spans with the tracer on at both ends
    are kept."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tracer.span("inside"):
            pass
        straddling = tracer.span("straddling")
        straddling.__enter__()
        prof.stop()
        straddling.__exit__(None, None, None)
    assert tracer.counts() == {"inside": 1}


def test_enable_false_turns_it_off(tracer):
    tracer.enable()
    with tracer.span("a"):
        pass
    tracer.enable(False)
    with tracer.span("a"):
        pass
    assert tracer.counts() == {"a": 1}


def _feed(tracer, spans):
    for name, a, b in spans:
        tracer._close(name, a, b, 1)


SPANS = [("a", 10, 20), ("b", 12, 15), ("c", 5, 40), ("d", 14, 15),
         ("e", 30, 31), ("f", 30, 31)]


@pytest.mark.parametrize("t", [0, 5, 10, 12, 14, 15, 16, 20, 21, 30, 31, 40,
                               41])
def test_innermost_at_agrees_with_the_benchmarks_spans(tracer, t):
    bench = Spans()
    bench.on = True
    for s in SPANS:
        bench.add(*s)
    _feed(tracer, SPANS)
    assert tracer.innermost_at(t) == bench.innermost_at(t)


def test_nested_spans_close_inner_first(tracer):
    tracer.enable()
    with tracer.span("step"):
        with tracer.span("round"):
            with tracer.sync_site("item"):
                pass
    names = [n for n, _, _ in tracer.spans()]
    assert names == ["sync.item", "round", "step"]
    (_, a0, b0), (_, a1, b1), (_, a2, b2) = tracer.spans()
    assert a2 <= a1 <= a0 <= b0 <= b1 <= b2
    assert tracer.innermost_at(a0) == "sync.item"
    assert tracer.innermost_at(a2) == "step"


def test_the_ring_wraps_and_counts_stay_exact():
    t = timers.Tracer(capacity=4)
    for k in range(10):
        t._close("a" if k % 3 else "b", 100 * k, 100 * k + k, 1)
    assert [s[1] for s in t.spans()] == [600, 700, 800, 900]
    assert t.counts() == {"a": 6, "b": 4}
    assert t.totals_ns() == {"a": 1 + 2 + 4 + 5 + 7 + 8, "b": 3 + 6 + 9}
    assert t.innermost_at(150) is None and t.innermost_at(905) == "b"
    s = t.summary()
    assert s["a"]["count"] == 6 and s["b"]["count"] == 4
    assert s["a"]["max_ms"] == 8e-6 and s["b"]["first_ms"] == 6e-6


def test_reset_forgets_and_keeps_the_switch(tracer):
    tracer.enable()
    with tracer.span("a"):
        pass
    tracer.reset()
    assert tracer.spans() == [] and tracer.counts() == {}
    assert tracer.recording()


# ---------------------------------------------------------------------------
# numerics with the tracer on and off
# ---------------------------------------------------------------------------


def _track(on):
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.data.synthetic import render_box_scene
    from droid_slam_tpu_torch.runtime.slam import Droid

    scene = render_box_scene(10, 96, 128, seed=3, motion_scale=0.12)
    cfg = SLAMConfig(image_size=(96, 128), buffer=32, warmup=5,
                     filter_thresh=0.0, compute_dtype="float32")
    droid = Droid(cfg, weights_path=WEIGHTS, device="cpu")
    timers.reset()
    timers.enable(on)
    try:
        for k in range(10):
            droid.track(float(k), scene["images"][k],
                        intrinsics=scene["intrinsics"][0])
    finally:
        timers.enable(False)
    counts = timers.counts()
    timers.reset()
    return droid, counts


def test_tracking_is_bit_equal_with_the_tracer_on_and_off():
    """Ten frames, five of them through the fused keyframe step."""
    torch.set_num_threads(2)
    (off, c_off), (on, c_on) = _track(False), _track(True)
    assert c_off == {}
    assert c_on["keyframe.round"] >= 5 * 4
    assert c_on["track.frame"] == 5
    assert sum(n for k, n in c_on.items() if k.startswith("sync.")) > 0
    n = off.video.counter
    assert on.video.counter == n
    for name in ("poses", "disps"):
        assert torch.equal(getattr(on.video.state, name)[:n],
                           getattr(off.video.state, name)[:n]), name
    g0, g1 = off.frontend.g, on.frontend.g
    for f in dataclasses.fields(g0):
        a, b = getattr(g0, f.name), getattr(g1, f.name)
        same = torch.equal(a, b) if torch.is_tensor(a) else (
            (a == b).all() if hasattr(a, "shape") else a == b)
        assert same, f.name


def _train(on, tmp_path):
    from droid_slam_tpu_torch.config import TrainConfig
    from droid_slam_tpu_torch.data.synthetic import SyntheticCurriculum
    from droid_slam_tpu_torch.training import trainer

    cfg = TrainConfig(image_size=(64, 96), n_frames=4, steps=100, iters=2,
                      edges=8, lr=2e-5, restart_prob=0.5,
                      ckpt_dir=str(tmp_path / f"ck{on}"), name="t")
    ds = SyntheticCurriculum(cfg, n_scenes=3)
    timers.reset()
    timers.enable(on)
    try:
        state = trainer.train(cfg, ds, max_steps=2, init_npz=WEIGHTS,
                              device="cpu", log_every=1,
                              log_dir=str(tmp_path / f"runs{on}"))
    finally:
        timers.enable(False)
    counts = timers.counts()
    timers.reset()
    return state, counts


def test_training_is_bit_equal_with_the_tracer_on_and_off(tmp_path):
    """Two `trainer.train` steps at test_torch_trainer's small size:
    every parameter and AdamW's moments equal."""
    torch.set_num_threads(2)
    (off, c_off), (on, c_on) = _train(False, tmp_path), _train(True, tmp_path)
    assert c_off == {}
    for name in ("train.draw", "train.graph", "train.batch", "train.apply",
                 "train.log"):
        assert c_on[name] == 2, name
    assert c_on["train.pass"] >= 2
    assert sum(n for k, n in c_on.items() if k.startswith("sync.")) > 0
    p_off, p_on = off.params(), on.params()
    for k, p in p_off.items():
        assert torch.equal(p_on[k], p), k
        s0, s1 = off.opt.state[p], on.opt.state[p_on[k]]
        for m in ("exp_avg", "exp_avg_sq"):
            assert torch.equal(s1[m], s0[m]), (k, m)
