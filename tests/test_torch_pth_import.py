"""The reference's `droid.pth` layout read by the port.

`make_droid_pth` (tests/test_pth_import.py) builds the checkpoint's key
surface from real module registration, with the DDP `module.` prefix and
the published 3-channel delta and weight heads.  The port's
`load_weights(net, path.pth)` must give parameters bit-equal to
`params_from_flax` of the JAX package's `load_weights(path.pth)`
(tolerance 0); the networks on those weights must agree with the flax
forward at tests/test_torch_models.py's f32 tolerance (1e-4 absolute and
relative); and the port's `Droid` must track tiny_seq frames from the
file.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_pth_import import make_droid_pth
from torch_port_common import TINY, tiny_seq

from droid_slam_tpu.models import convert as jconvert
from droid_slam_tpu.models.droidnet import DroidNet as JDroidNet
from droid_slam_tpu.models.droidnet import normalize_images as jnorm
from droid_slam_tpu_torch.models import convert as tconvert
from droid_slam_tpu_torch.models.droidnet import DroidNet as TDroidNet
from droid_slam_tpu_torch.models.droidnet import normalize_images as tnorm


@pytest.fixture(scope="module")
def pth(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ckpt") / "droid.pth")
    make_droid_pth(path)
    return path


@pytest.fixture(scope="module")
def tnet(pth):
    net = TDroidNet()
    tconvert.load_weights(net, pth)
    return net.eval().requires_grad_(False)


def test_pth_params_bit_equal_to_the_jax_import(pth, tnet):
    want = tconvert.params_from_flax(jconvert.load_weights(pth))
    got = tnet.state_dict()
    assert set(got) == set(want) and len(got) == 102
    for k in want:
        assert got[k].dtype == torch.float32
        assert torch.equal(got[k], want[k]), k
    # the published 3-channel heads were truncated to 2
    assert got["update.delta_2.weight"].shape[0] == 2
    assert got["update.weight_2.bias"].shape == (2,)
    # the truncated rows are the file's first two output channels
    sd = torch.load(pth, weights_only=True)
    assert torch.equal(got["update.delta_2.weight"],
                       sd["module.update.delta.2.weight"][:2])


def test_load_weights_rejects_other_files(tmp_path):
    with pytest.raises(ValueError, match=r"\.npz or a \.pth"):
        tconvert.load_weights(TDroidNet(), str(tmp_path / "w.ckpt"))


def test_forward_on_pth_weights_matches_jax(pth, tnet):
    params = jconvert.load_weights(pth)
    jnet = JDroidNet(dtype=None)
    rng = np.random.default_rng(0)

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)

    img = rng.integers(0, 256, (2, 32, 48, 3)).astype(np.uint8)
    x_t, x_j = tnorm(torch.from_numpy(img)), jnorm(jnp.asarray(img))
    close(tnet.fnet(x_t),
          jnet.apply(params, x_j, method=lambda m, x: m.fnet(x)))
    close(tnet.cnet(x_t),
          jnet.apply(params, x_j, method=lambda m, x: m.cnet(x)))

    E, h, w = 5, 6, 8
    net0 = np.tanh(rng.standard_normal((E, h, w, 128))).astype(np.float32)
    inp = np.maximum(rng.standard_normal((E, h, w, 128)), 0).astype(
        np.float32)
    corr = rng.standard_normal((E, h, w, 196)).astype(np.float32)
    flow = (4 * rng.standard_normal((E, h, w, 4))).astype(np.float32)
    ix = np.array([0, 0, 1, 2, 1], np.int64)
    got = tnet.update(*[torch.from_numpy(a) for a in (net0, inp, corr, flow)],
                      ix=torch.from_numpy(ix), nseg=3)
    want = jnet.apply(
        params, *[jnp.asarray(a) for a in (net0, inp, corr, flow)],
        method=lambda m, n, i, c, f: m.update(
            n, i, c, f, ix=jnp.asarray(ix, jnp.int32), nseg=3))
    for g, wv in zip(got[:4], want[:4]):      # net, delta, weight, eta
        close(g, wv)


def test_droid_tracks_on_pth(pth):
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.runtime.slam import Droid

    imgs, intr = tiny_seq()
    droid = Droid(SLAMConfig(**TINY), weights_path=pth, device="cpu")
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        for k, im in enumerate(imgs[:6]):
            droid.track(float(k), im, intrinsics=intr)
    finally:
        torch.set_num_threads(n)
    assert droid.frontend.is_initialized
    poses = droid.video.state.poses[: droid.video.counter].numpy()
    assert np.isfinite(poses).all()
    np.testing.assert_allclose(np.linalg.norm(poses[:, 3:], axis=-1), 1.0,
                               atol=1e-5)
