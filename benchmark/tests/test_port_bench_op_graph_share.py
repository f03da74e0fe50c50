"""The reader of `op.graph_share` (benchmark/metrics/op.graph_share.py)
on a tracer state fed by hand: 100 where every round's update operator
replayed, 0 where rounds ran and none replayed, and None where no round
was recorded, or the program has no graphed update operator (as before
it was graphed) or no such tracer.

    python -m pytest benchmark/tests/test_port_bench_op_graph_share.py
"""

import sys
import types

import pytest

from benchmark.lib import loader, program_trace
from droid_slam_tpu_torch.utils import timers

MS = 1_000_000
TRACK = dict(latency_ms=[1.0, 2.0, 3.0], trace=dict(window_s=2.0))
ROUNDS = [("round.update_op", 10 * k * MS, (10 * k + 5) * MS)
          for k in range(4)]
REPLAYS = [("op.replay", (10 * k + 1) * MS, (10 * k + 2) * MS)
           for k in range(4)]
TRACKING = ["mono-tartanair.fast", "mono-tartanair.slow",
            "stereo-euroc.fast"]


def _feed(spans):
    timers.reset()
    for name, a, b in spans:
        timers.TRACER._close(name, a, b, 1)


@pytest.fixture(autouse=True)
def _clean():
    timers.reset()
    yield
    timers.reset()


def test_declared_for_the_tracking_cells():
    m = next(m for m in loader.benchmark()["per_layer"]
             if m["name"] == "op.graph_share")
    assert m["workloads"][:3] == TRACKING
    assert (m["unit"], m["better"], m["moves"], m["layer"]) == (
        "%", "higher", "frames_per_s", "keyframe step")


@pytest.mark.parametrize("spans,want", [
    (ROUNDS + REPLAYS, 100.0), (ROUNDS + REPLAYS[:3], 75.0),
    (ROUNDS, 0.0), (REPLAYS, None), ([], None)])
def test_reader(spans, want):
    _feed(spans)
    got = loader.reader("op.graph_share")(TRACK)
    assert got == (None if want is None else pytest.approx(want))


def test_reader_gives_none_without_the_programs_tracer(monkeypatch):
    import droid_slam_tpu_torch.utils as utils

    _feed(ROUNDS + REPLAYS)
    monkeypatch.setattr(utils, "timers",
                        types.SimpleNamespace(GLOBAL_TIMERS=object()))
    assert program_trace.tracer() is None
    assert loader.reader("op.graph_share")(TRACK) is None


def test_reader_gives_none_where_the_program_has_no_graphed_operator(
        monkeypatch):
    """The program before the operator was graphed records
    `round.update_op` and no `op.replay`: the metric does not exist
    there, rather than reading 0."""
    _feed(ROUNDS)
    monkeypatch.setitem(sys.modules,
                        "droid_slam_tpu_torch.models.update_graphs", None)
    assert loader.reader("op.graph_share")(TRACK) is None
