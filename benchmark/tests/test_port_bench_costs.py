"""The operation and byte counts against hand counts at small shapes."""

import pytest
import torch

from benchmark.lib import costs
from benchmark.reference.droidnet import DroidNet


def _hooked_conv_flops(module, *args, **kwargs):
    """FLOPs of every Conv2d that runs, counted from its output shape."""
    total = 0

    def hook(m, inp, out):
        nonlocal total
        k = m.kernel_size[0] * m.kernel_size[1]
        total += 2 * m.in_channels * m.out_channels * k * out[0].numel() \
            // m.out_channels * out.shape[0]

    hs = [m.register_forward_hook(hook) for m in module.modules()
          if isinstance(m, torch.nn.Conv2d)]
    with torch.no_grad():
        module(*args, **kwargs)
    for h in hs:
        h.remove()
    return total


@pytest.mark.parametrize("H,W,dim", [(32, 48, 128), (40, 64, 256),
                                     (36, 52, 128)])
def test_encoder_flops(H, W, dim):
    net = DroidNet()
    enc = net.fnet if dim == 128 else net.cnet
    got = _hooked_conv_flops(enc, torch.zeros(2, H, W, 3))
    assert costs.encoder_flops(H, W, dim) * 2 == got


@pytest.mark.parametrize("E,nseg,upmask", [(3, 0, False), (5, 2, False),
                                           (4, 3, True)])
def test_update_flops(E, nseg, upmask):
    h, w = 6, 8
    upd = DroidNet().update
    z = torch.zeros(E, h, w, 128)
    kw = dict(ix=torch.arange(E) % nseg, nseg=nseg,
              with_upmask=upmask) if nseg else {}
    got = _hooked_conv_flops(upd, z, z, torch.zeros(E, h, w, 196),
                             torch.zeros(E, h, w, 4), **kw)
    assert costs.update_flops(E, h, w, nseg, upmask) == got


def test_volume_and_gate_flops():
    assert costs.volume_flops(2, 3, 4) == 2 * 2 * 12 * 12 * 128
    assert costs.gate_corr_flops(3, 4) == 2 * 12 * 4 * 49 * 128


def test_window_bytes_by_hand():
    # a query at (0.5, 0.5) of a 4x4 plane: its 8x8 window [-3, 4] holds
    # columns and rows 0..3 in bounds, 16 elements
    c = torch.tensor([[0.5, 0.5]])
    assert costs.window_bytes(c, 4, 4, 2) == 16 * 2
    # far outside: nothing to read
    assert costs.window_bytes(torch.tensor([[-50.0, 3.0]]), 4, 4, 2) == 0
    # inside a large plane: the whole 8x8 window
    assert costs.window_bytes(torch.tensor([[10.2, 10.7]]), 32, 32, 4) \
        == 64 * 4


def test_pyramid_bytes_by_hand():
    c = torch.tensor([[10.2, 10.7]])
    planes = [(32, 32), (16, 16), (8, 8), (4, 4)]
    # level coords 10.2/2^l: levels 0-1 hold the whole window (64); level
    # 2 at (2.55, 2.68) of 8x8 holds columns and rows -1..6 less -1 (49);
    # level 3 at (1.28, 1.34) of 4x4 holds columns and rows 0..3 (16)
    want = (64 + 64 + 49 + 16) * 2 + 4 * 49 * 4 + 8
    assert costs.pyramid_bytes(c, planes, 2) == want
