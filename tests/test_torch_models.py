"""Networks of the PyTorch port vs the flax forward, with the shipped
weights (weights/droid_synth.npz) carried over by `params_from_flax`.

f32: 1e-4 absolute/relative — the same convolutions summed in another
order over up to 7·7·4 or 3·3·448 terms per output.
bf16: both frameworks round activations to bf16 after every layer but at
different places inside the ops (flax rounds the GroupAgg/segment sums in
bf16, the port sums in f32), so outputs agree to a few bf16 ulps of the
largest activations: atol 0.1 on O(1-10) features, checked together
with a 0.02 bound on the mean error.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_port_common import WEIGHTS

from droid_slam_tpu.models import convert as jconvert
from droid_slam_tpu.models.droidnet import DroidNet as JDroidNet
from droid_slam_tpu.models.droidnet import normalize_images as jnorm
from droid_slam_tpu_torch.models import convert as tconvert
from droid_slam_tpu_torch.models.droidnet import DroidNet as TDroidNet
from droid_slam_tpu_torch.models.droidnet import normalize_images as tnorm

H, W = 32, 48


@pytest.fixture(scope="module")
def params():
    return jconvert.load_npz_weights(WEIGHTS)


def _tnet(dtype):
    net = TDroidNet()
    tconvert.load_weights(net, WEIGHTS)
    return net.to(dtype).eval().requires_grad_(False)


def _jnet(dtype):
    return JDroidNet(dtype=jnp.bfloat16 if dtype == torch.bfloat16 else None)


def _close(got, want, dtype):
    got = got.float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    if dtype == torch.float32:
        np.testing.assert_allclose(got, want, atol=1e-4, rtol=1e-4)
    else:
        err = np.abs(got - want)
        assert err.max() < 0.1, err.max()
        assert err.mean() < 0.02, err.mean()


def test_all_npz_arrays_consumed():
    tree = tconvert.load_npz_weights(WEIGHTS)
    sd = tconvert.params_from_flax(tree)
    with np.load(WEIGHTS) as data:
        assert len(data.files) == 102
        assert len(sd) == 102
    net = TDroidNet()
    missing, unexpected = net.load_state_dict(sd, strict=False)
    assert not missing and not unexpected
    assert len(net.state_dict()) == 102


def test_params_from_flax_layout():
    """HWIO kernels become OIHW weights."""
    tree = tconvert.load_npz_weights(WEIGHTS)
    sd = tconvert.params_from_flax({"params": tree})
    k = tree["update"]["gru"]["convz"]["kernel"]          # (3,3,448,128)
    w = sd["update.gru.convz.weight"].numpy()
    assert w.shape == (128, 448, 3, 3)
    np.testing.assert_array_equal(w[5, 7, 1, 2], k[1, 2, 7, 5])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoders(params, dtype):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (2, H, W, 3)).astype(np.uint8)
    net, jnet = _tnet(dtype), _jnet(dtype)
    x_t = tnorm(torch.from_numpy(img))
    x_j = jnorm(jnp.asarray(img))
    np.testing.assert_allclose(x_t.numpy(), np.asarray(x_j), atol=1e-6)
    _close(net.fnet(x_t),
           jnet.apply(params, x_j, method=lambda m, x: m.fnet(x)), dtype)
    _close(net.cnet(x_t),
           jnet.apply(params, x_j, method=lambda m, x: m.cnet(x)), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_update(params, dtype):
    rng = np.random.default_rng(1)
    E, h, w = 5, 6, 8
    net0 = np.tanh(rng.standard_normal((E, h, w, 128))).astype(np.float32)
    inp = np.maximum(rng.standard_normal((E, h, w, 128)), 0).astype(
        np.float32)
    corr = rng.standard_normal((E, h, w, 196)).astype(np.float32)
    flow = (4 * rng.standard_normal((E, h, w, 4))).astype(np.float32)
    ix = np.array([0, 0, 1, 2, 1], np.int64)
    tnet, jnet = _tnet(dtype), _jnet(dtype)

    got = tnet.update(*[torch.from_numpy(a) for a in (net0, inp, corr, flow)],
                      ix=torch.from_numpy(ix), nseg=3)
    want = jnet.apply(
        params, *[jnp.asarray(a) for a in (net0, inp, corr, flow)],
        method=lambda m, n, i, c, f: m.update(
            n, i, c, f, ix=jnp.asarray(ix, jnp.int32), nseg=3))
    for g, wv in zip(got[:4], want[:4]):      # net, delta, weight, eta
        _close(g, wv, dtype)

    # without GraphAgg (the motion gate's form)
    got = tnet.update(*[torch.from_numpy(a) for a in (net0, inp, corr)])
    want = jnet.apply(params, *[jnp.asarray(a) for a in (net0, inp, corr)],
                      method=lambda m, n, i, c: m.update(n, i, c))
    for g, wv in zip(got, want):
        _close(g, wv, dtype)
