"""The tracking check fails a dense BA fault on the path the tracking
cells run: the fused keyframe step's fixed-shape BA
(`droid_slam_tpu_torch.ops.dba_static.ba`, replayed as a CUDA graph on
the card and run eagerly on the CPU).  The fault is the one
test_port_bench_control.py plants in `ops/dba.ba`: disparities a
hundredth high.  At the CPU's size (benchmark/tests/small.py).

    python -m pytest benchmark/tests/test_port_bench_static_ba_fault.py
"""

import pytest

from benchmark.tests.small import run_small

TRACK = ["mono-tartanair.fast", "mono-tartanair.slow"]


def _disps_high(orig):
    """A dense BA whose disparities come out a hundredth high."""
    def ba(*args, **kwargs):
        poses, disps = orig(*args, **kwargs)
        return poses, disps * 1.01
    return ba


@pytest.mark.parametrize("workload", TRACK)
def test_static_ba_fault_is_not_correct(monkeypatch, workload):
    from droid_slam_tpu_torch.ops import dba_static

    monkeypatch.setattr(dba_static, "ba", _disps_high(dba_static.ba))
    result = run_small(workload)[0]
    assert not result["correct"], result["checks"]
