"""The check separates: sound runs pass it, while the control (the
reference in the precision below the configuration's) and the faults a
cell can have fail it.  At the CPU's size: tracking at 96×128, training
at 64×96 with 4 frames and 2 unrolled iterations (benchmark/tests/
small.py); the chip's readings at the cells' own sizes are in PERF.md."""

import numpy as np
import pytest
import torch

from benchmark.tests.small import run_small

TRACK = ["mono-tartanair.fast", "mono-tartanair.slow"]


@pytest.mark.parametrize("workload", TRACK + ["train-tartanair.synth"])
def test_sound_run_is_correct(workload):
    result = run_small(workload)[0]
    assert result["correct"], result["checks"]


@pytest.mark.parametrize("workload", TRACK)
def test_control_is_not_correct(workload):
    """The float8 control of the tracking cells (the training cell's TF32
    control exists only on the card: test_port_bench_cuda.py)."""
    result = run_small(workload, control=True)[0]
    assert not result["correct"], result["checks"]


def _unchanged(self, g, vols=None):
    """A round that returns its state unchanged."""
    return g


def _half_edges(orig):
    """The update operator over half of the active edges only."""
    def update_op(self, g, act, vols=None):
        k = max(1, len(act) // 2)
        return orig(self, g, act[:k],
                    None if vols is None else [v[:k] for v in vols])
    return update_op


def _altered(orig):
    """A round whose targets are moved by half a pixel where the update
    operator produced them."""
    def update_round(self, g, vols=None):
        g = orig(self, g, vols)
        a = torch.as_tensor(np.nonzero(g.active)[0], device=g.target.device)
        g.target[a] += 0.5
        return g
    return update_round


def _weights_altered(orig):
    """An update operator whose confidence weights come out a tenth low."""
    def update_op(self, g, act, vols=None):
        out = orig(self, g, act, vols)
        a = torch.as_tensor(act, device=g.weight.device)
        g.weight[a] *= 0.9
        return out
    return update_op


def _ba_altered(orig):
    """A dense BA whose disparities come out a hundredth high."""
    def ba(*args, **kwargs):
        poses, disps = orig(*args, **kwargs)
        return poses, disps * 1.01
    return ba


@pytest.mark.parametrize("workload", TRACK)
@pytest.mark.parametrize("fault", ["unchanged", "half_edges", "altered",
                                   "weights_altered", "ba_altered"])
def test_tracking_fault_is_not_correct(monkeypatch, workload, fault):
    from droid_slam_tpu_torch.ops import dba
    from droid_slam_tpu_torch.runtime.fused import KeyframeStep

    if fault == "unchanged":
        monkeypatch.setattr(KeyframeStep, "update_round", _unchanged)
    elif fault == "half_edges":
        monkeypatch.setattr(KeyframeStep, "update_op",
                            _half_edges(KeyframeStep.update_op))
    elif fault == "weights_altered":
        monkeypatch.setattr(KeyframeStep, "update_op",
                            _weights_altered(KeyframeStep.update_op))
    elif fault == "ba_altered":
        monkeypatch.setattr(dba, "ba", _ba_altered(dba.ba))
    else:
        monkeypatch.setattr(KeyframeStep, "update_round",
                            _altered(KeyframeStep.update_round))
    result = run_small(workload)[0]
    assert not result["correct"], result["checks"]


def _doubled_update_gradients(accum):
    """A pass whose update operator's gradients come out doubled (the
    global clip would undo a uniform scale)."""
    def altered(acc, net, batch, Gs0, disp0):
        acc0 = {k: v.clone() for k, v in acc.items()}
        acc, metrics = accum(acc, net, batch, Gs0, disp0)
        for k in acc:
            if k.startswith("update."):
                acc[k] = acc0[k] + 2.0 * (acc[k] - acc0[k])
        return acc, metrics
    return altered


def _train_fault(fault):
    from droid_slam_tpu_torch.training import trainer

    orig = trainer.make_train_step

    def make(*a, **k):
        accum, apply = orig(*a, **k)
        if fault == "unchanged":
            def unchanged(state, grads):
                keep = {k: p.detach().clone()
                        for k, p in state.net.named_parameters()}
                out = apply(state, grads)
                with torch.no_grad():
                    for k, p in state.net.named_parameters():
                        p.copy_(keep[k])
                return out
            return accum, unchanged

        return _doubled_update_gradients(accum), apply
    return make


@pytest.mark.parametrize("fault", ["unchanged", "altered"])
def test_training_fault_is_not_correct(monkeypatch, fault):
    from droid_slam_tpu_torch.training import trainer

    monkeypatch.setattr(trainer, "make_train_step", _train_fault(fault))
    result = run_small("train-tartanair.synth")[0]
    assert not result["correct"], result["checks"]
