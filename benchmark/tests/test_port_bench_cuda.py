"""On the card: a run of every cell prints the result the contract asks
for, with `correct` true.  Skips without a CUDA card.

    python -m pytest -m cuda benchmark/tests/test_port_bench_cuda.py
"""

import pytest
import torch

from benchmark.lib import loader
from benchmark.run import run_cell

BENCH = loader.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_is_correct(card, cell, trace):
    """A run at the benchmark's own window: the check draws its samples
    from all of the window's rounds and frames, and a longer window holds
    a larger map and graph."""
    result, numbers, info = run_cell(cell, 2 ** 31 + 23,
                                     BENCH["run_seconds"], trace, card)
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["memory_peak_bytes"] > 0
    assert list(result)[-1] == "checks"
    if trace:
        assert 0 < result["device"]["busy_s"] <= result["device"]["window_s"]
        assert len(result["breakdown"]["device_ops"]) <= 10
        for name, m in result["metrics"].items():
            if name.endswith("_roofline") or "mfu" in name:
                assert 0 < m["value"] <= 100, name


@pytest.mark.cuda
def test_the_training_control_is_not_correct(card):
    """TF32, the control of a float32 training step, exists only on the
    card: the reference in TF32 in the program's place fails the check at
    the cell's own size."""
    result = run_cell("train-tartanair.synth", 2 ** 31 + 29, 2.0, 0, card,
                      control=True)[0]
    assert not result["correct"], result["checks"]
