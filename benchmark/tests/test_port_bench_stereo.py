"""The stereo cell at the CPU's size (96×128, benchmark/tests/small.py):
a clean run is `correct`, and the control and a planted fault (the left
camera's features in the right one's place on the rig edges) are not;
its runner checks the sampled keyframes' features on both cameras and
rounds with rig edges; `stereo.edge_share` reads the program's edge
counters, and nothing where the program has none; `mfu.track` counts
fnet on both cameras; and the new reference loads neither JAX nor the
port, the new harness files no JAX."""

import pytest

from benchmark.lib import loader
from benchmark.tests.small import run_small

CELL = "stereo-euroc.fast"


def test_sound_run_is_correct():
    result, numbers, info = run_small(CELL)
    assert result["correct"], result["checks"]
    assert all(info["samples_checked"].values())


def test_control_is_not_correct():
    result = run_small(CELL, control=True)[0]
    assert not result["correct"], result["checks"]


def _left_for_right(fmaps, ii, jj):
    return fmaps[jj, 0]


def test_left_camera_for_the_right_is_not_correct(monkeypatch):
    from droid_slam_tpu_torch.runtime import factor_graph, fused

    monkeypatch.setattr(factor_graph, "target_fmaps", _left_for_right)
    monkeypatch.setattr(fused, "target_fmaps", _left_for_right)
    result = run_small(CELL)[0]
    assert not result["correct"], result["checks"]
    assert (result["checks"]["round_end_gap"]["value"]
            > result["checks"]["round_end_gap"]["limit"])


def test_runner_checks_both_cameras(monkeypatch):
    from benchmark.runners import track_stereo

    seen = {}
    check = track_stereo.check

    def spy(ctx, rec):
        seen.update(rec)
        return check(ctx, rec)

    monkeypatch.setattr(track_stereo, "check", spy)
    run_small(CELL)
    fmaps = seen["encoded"]["fmaps"]
    assert fmaps.shape[1] == 2
    assert (fmaps[:, 0] - fmaps[:, 1]).abs().max() > 0
    ea = len(seen["rounds"][0][0]["active"])
    assert any((pre["ii"] == pre["jj"])[:ea][pre["active"]].any()
               for pre, _ in seen["rounds"])


class _Tracer:
    def __init__(self, counts):
        self._counts = counts

    def counts(self):
        return dict(self._counts)


@pytest.mark.parametrize("counts, want", [
    ({"edges.active": 40, "edges.stereo": 6}, 15.0),
    ({"keyframe.round": 3}, None),
    ({}, None),
])
def test_edge_share_reads_the_counters(monkeypatch, counts, want):
    reader = loader.load_module(
        f"{loader.HERE}/metrics/stereo.edge_share.py", "edge_share_t")
    monkeypatch.setattr(reader, "tracer", lambda: _Tracer(counts))
    assert reader.read({}) == want


def test_edge_share_without_a_tracer_reads_nothing(monkeypatch):
    reader = loader.load_module(
        f"{loader.HERE}/metrics/stereo.edge_share.py", "edge_share_n")
    monkeypatch.setattr(reader, "tracer", lambda: None)
    assert reader.read({}) is None


def test_the_stereo_reference_loads_neither_jax_nor_the_port():
    from benchmark.lib import guard
    from benchmark.tests.test_port_bench_imports import _loaded_after

    mods = _loaded_after("import benchmark.reference.tracking_stereo")
    assert guard.forbidden_modules(mods) == []
    assert not [m for m in mods if m.split(".")[0] == "droid_slam_tpu_torch"]


def test_the_new_runner_and_generators_load_no_jax():
    from benchmark.lib import guard
    from benchmark.tests.test_port_bench_imports import _loaded_after

    mods = _loaded_after(
        "import benchmark.runners.track_stereo,"
        " benchmark.generators.stereo_box_walk,"
        " benchmark.generators.tartan_files, benchmark.limit_readings\n"
        "import droid_slam_tpu_torch.data.tartan")
    assert guard.forbidden_modules(mods) == []


def test_mfu_counts_fnet_on_both_cameras():
    """The traced run's encoder hook takes the batch from the input it
    sees: a rig of two images is two fnet passes."""
    import torch

    from benchmark.lib import costs
    from benchmark.runners.track import Probe

    probe = Probe.__new__(Probe)
    probe.window, probe.flops = True, 0
    hook = probe._encoder_hook(128)
    hook(None, (torch.zeros(2, 320, 512, 3),), None)
    assert probe.flops == 2 * costs.encoder_flops(320, 512, 128)
