"""The plain reference agrees with the port's CPU path at 96×128 when
both compute in float32: the encoders, the motion gate, an update round
followed from the port's state, and the first training steps."""

import os

import numpy as np
import pytest
import torch

from benchmark.generators import box_walk
from benchmark.lib import loader
from benchmark.reference import tracking as ref
from benchmark.reference.weights import load_net
from benchmark.tests.small import CPU, run_small

WEIGHTS = os.path.join(loader.ROOT, "weights", "droid_synth.npz")


@pytest.fixture(scope="module")
def frames():
    p = loader.load_json(os.path.join(loader.HERE, "traffic", "fast.json"))
    return box_walk.make(dict(p, frames=4), 96, 128, 3, CPU)["images"]


@pytest.fixture(scope="module")
def nets():
    from droid_slam_tpu_torch.models.convert import load_weights
    from droid_slam_tpu_torch.models.droidnet import DroidNet

    port = DroidNet()
    load_weights(port, WEIGHTS)
    return port.eval(), load_net(WEIGHTS, CPU).eval()


def test_encoders_agree(frames, nets):
    from droid_slam_tpu_torch.models.droidnet import normalize_images

    port, net = nets
    with torch.no_grad():
        x = normalize_images(frames)
        want = (port.fnet(x),) + port.context(x)
    for got, w in zip(ref.encode(net, frames), want):
        torch.testing.assert_close(got, w, atol=1e-4, rtol=1e-4)


def test_gate_agrees(frames, nets):
    from droid_slam_tpu_torch.models.droidnet import normalize_images
    from droid_slam_tpu_torch.ops import corr
    from droid_slam_tpu_torch.runtime.state import pool_pyramid

    port, net = nets
    with torch.no_grad():
        x = normalize_images(frames[[0, 2]])
        f = port.fnet(x)
        n, i = port.context(x[:1])
        taps = corr.gate_corr_pyramid(f[0:1] / 4.0, pool_pyramid(f[1:2] / 4.0))
        _, delta, _ = port.update(n, i, taps)
    torch.testing.assert_close(ref.gate_flow(net, frames[2], frames[0]),
                               delta, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("workload", ["mono-tartanair.fast",
                                      "mono-tartanair.slow"])
def test_tracking_check_reads_storage_rounding_in_float32(workload):
    """With the network in float32 the gaps are the rounding of the map's
    stores alone (features in bfloat16, context in float16): about a
    tenth of what the bfloat16 network reads (the weights about half).
    The round's end adds the dense BA, float32 in the port against the
    reference's float64: its reprojections stay as close as the
    targets."""
    result, numbers, info = run_small(workload, compute_dtype="float32")
    assert all(info["samples_checked"].values())
    got = {n["name"]: n["value"] for n in numbers}
    assert got["encoder_gap"] < 4e-3
    assert got["gate_gap"] < 2e-3
    assert got["round_flow_px"] < 2e-3
    assert got["round_weight_gap"] < 6e-4
    assert got["round_damping_gap"] < 6e-3
    assert got["round_end_gap"] < 4e-3


def test_training_check_reads_near_zero():
    """On the CPU the port's training step and the reference sum in one
    order: their gaps are a small share of what moving the images by a
    thousandth of a grey level does to the reference."""
    result, numbers, info = run_small("train-tartanair.synth")
    got = {n["name"]: n["value"] for n in numbers}
    assert info["samples_checked"]["passes"] >= 3
    assert got["grad_gap_ratio"] < 0.1
    assert got["update_gap_ratio"] < 0.2
