"""The readers of the program's own spans and sync counts
(benchmark/lib/program_trace.py) on a tracer state fed by hand: each
gives its value, and None where nothing was recorded or the program has
no such tracer.

    python -m pytest benchmark/tests/test_port_bench_program_trace.py
"""

import types

import pytest

from benchmark.lib import loader, program_trace
from droid_slam_tpu_torch.utils import timers

MS = 1_000_000
# (name, start, end, waits): a window of 2 s with 3 frames or 4 passes
FED = [("sync.gate.item", 0, 2 * MS, 1), ("sync.h2d.rows", 5 * MS, 6 * MS, 1),
       ("sync.graphagg.bincount", 7 * MS, 10 * MS, 2),
       ("keyframe.round", 20 * MS, 50 * MS, 1),
       ("keyframe.round", 60 * MS, 70 * MS, 1),
       ("train.draw", 100 * MS, 140 * MS, 1),
       ("train.graph", 140 * MS, 150 * MS, 1),
       ("train.batch", 150 * MS, 160 * MS, 1),
       ("train.pass", 160 * MS, 900 * MS, 1)]
TRACK = dict(latency_ms=[1.0, 2.0, 3.0], trace=dict(window_s=2.0))
TRAIN = dict(passes=4, trace=dict(window_s=2.0))

WANT = {
    "host.syncs_per_frame": (TRACK, 4 / 3),
    "host.sync_wait_share.track": (TRACK, 100 * 6e-3 / 2.0),
    "keyframe.round_ms": (TRACK, 20.0),
    "host.syncs_per_pass": (TRAIN, 1.0),
    "host.sync_wait_share.train": (TRAIN, 100 * 6e-3 / 2.0),
    "host.prep_share.train": (TRAIN, 100 * 60e-3 / 2.0),
}


@pytest.fixture
def fed():
    timers.reset()
    for name, a, b, n in FED:
        timers.TRACER._close(name, a, b, n)
    yield
    timers.reset()


def test_the_new_metrics_are_declared():
    names = {m["name"] for m in loader.benchmark()["per_layer"]}
    assert set(WANT) <= names


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_on_a_known_state(fed, name):
    rec, want = WANT[name]
    assert loader.reader(name)(rec) == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_none_when_nothing_was_recorded(name):
    timers.reset()
    assert loader.reader(name)(WANT[name][0]) is None


@pytest.mark.parametrize("name", sorted(WANT))
def test_reader_gives_none_without_the_programs_tracer(fed, monkeypatch,
                                                       name):
    """A program whose utils/timers has phase timers and no tracer."""
    import droid_slam_tpu_torch.utils as utils

    monkeypatch.setattr(utils, "timers",
                        types.SimpleNamespace(GLOBAL_TIMERS=object()))
    assert program_trace.tracer() is None
    assert loader.reader(name)(WANT[name][0]) is None
