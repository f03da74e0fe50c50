"""The training slice as a whole: with the same parameters carried
across, one accumulate step of the port gives the JAX package's loss,
metrics and (mapped back onto the flax tree) gradients, and apply steps
give its parameters.  Small size: 4 frames of 64×96, 2 update iterations,
6 temporal edges padded to 8 slots, the shipped weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.config import TrainConfig as JTrainConfig
from droid_slam_tpu.models import layers as jlayers
from droid_slam_tpu.models.convert import load_npz_weights as jload_npz
from droid_slam_tpu.models.droidnet import DroidNet as JDroidNet
from droid_slam_tpu.training import train_step as jts
from droid_slam_tpu_torch.config import TrainConfig
from droid_slam_tpu_torch.data.synthetic import render_box_scene
from droid_slam_tpu_torch.geom.graph_utils import temporal_graph
from droid_slam_tpu_torch.models import convert
from droid_slam_tpu_torch.models import layers as tlayers
from droid_slam_tpu_torch.training import train_step as tts
from torch_port_common import WEIGHTS

N, H, W, ITERS, CAP = 4, 64, 96, 2, 8


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in convert._flatten(tree)}


@pytest.fixture(scope="module")
def problem():
    """One batch in numpy, the shipped parameters as a flax tree, and the
    batch as each package's arrays."""
    torch.set_num_threads(1)
    data = render_box_scene(N, H, W, seed=1, motion_scale=0.08)
    ii, jj = temporal_graph(N, r=1)
    ii_p, jj_p, emask = tts.pad_edges(ii, jj, CAP)
    disps = 1.0 / data["depths"]
    arrays = dict(images=data["images"].astype(np.float32)[None],
                  poses=data["poses_c2w"][None],
                  disps=disps[:, 3::8, 3::8][None], disps_full=disps[None],
                  intrinsics=data["intrinsics"][None])
    jb = {k: jnp.asarray(v) for k, v in arrays.items()}
    jb.update(ii=jnp.asarray(ii_p, jnp.int32), jj=jnp.asarray(jj_p, jnp.int32),
              edge_mask=jnp.asarray(emask))
    tb = {k: torch.from_numpy(np.array(v, np.float32))
          for k, v in arrays.items()}
    tb.update(ii=torch.from_numpy(ii_p), jj=torch.from_numpy(jj_p),
              edge_mask=torch.from_numpy(emask))
    params = jax.tree.map(jnp.asarray, jload_npz(WEIGHTS))
    return dict(jb=jb, tb=tb, params=params)


def _port_net(params):
    cfg = TrainConfig(image_size=(H, W), n_frames=N, steps=100, lr=1e-3)
    state = tts.create_train_state(cfg, seed=0, device="cpu")
    state.net.load_state_dict(
        convert.params_from_flax(jax.tree.map(np.asarray, params)),
        strict=True)
    return state


def _accumulate_both(problem):
    jb, tb, params = problem["jb"], problem["tb"], problem["params"]
    net = JDroidNet(dtype=None)
    tx = jts.make_optimizer(JTrainConfig(image_size=(H, W), n_frames=N,
                                         steps=100, lr=1e-3))
    accum, _ = jts.make_train_step(net, tx, iters=ITERS)
    zeros = jax.tree.map(jnp.zeros_like, params["params"])
    jg, jm = accum(zeros, params, jb, jnp.zeros((1, N, 7)),
                   jnp.zeros((1, N, H // 8, W // 8)))
    state = _port_net(params)
    taccum, _ = tts.make_train_step(iters=ITERS)
    tg, tm = taccum(tts.zero_grads(state.net), state.net, tb,
                    torch.zeros(1, N, 7), torch.zeros(1, N, H // 8, W // 8))
    return _flat(jg), jm, _flat(convert.params_to_flax(tg)["params"]), tm


def _global_rel(a, b):
    num = np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in a))
    return num / np.sqrt(sum((a[k] ** 2).sum() for k in a))


def test_accumulate_step_matches_jax(problem):
    """Loss and metrics within 1e-4 relative (f32 BA solves summed in
    another order, two iterations deep), final poses 2e-5, disparities
    2e-4.  Gradients: the whole tree within 2% of its norm.  `grad_clip`
    zeroes every gradient element above 0.01, so an element that rounds
    to the other side of the threshold moves the gradient by 0.01 at
    once; read on this batch: 0.19% of the norm.  The next test removes
    that threshold and holds the gradients tightly."""
    jg, jm, tg, tm = _accumulate_both(problem)
    assert set(jm) == set(tm)
    for k in jm:
        if k == "_Gs_last":
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       atol=2e-5)
        elif k == "_disp_last":
            np.testing.assert_allclose(tm[k].numpy(), np.asarray(jm[k]),
                                       atol=2e-4)
        else:
            np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                       rtol=1e-4, atol=1e-6, err_msg=k)
    assert set(jg) == set(tg)
    print("gradient tree relative difference", _global_rel(jg, tg))
    assert _global_rel(jg, tg) < 0.02, _global_rel(jg, tg)


def test_accumulate_gradients_match_jax_without_clip_threshold(
        problem, monkeypatch):
    """With grad_clip's threshold lifted in both packages (its NaN guard
    stays), the gradients of every parameter agree: each leaf within 1%
    of its largest element (read: 0.3%), the whole tree within 0.2% of
    its norm (read: 0.034%); leaves whose gradient is rounding noise (the
    biases in front of an instance norm, below 1e-6) within 1e-6."""
    monkeypatch.setattr(jlayers, "GRAD_CLIP", 1e9)
    monkeypatch.setattr(tlayers, "GRAD_CLIP", 1e9)
    jg, _, tg, _ = _accumulate_both(problem)
    for k in jg:
        np.testing.assert_allclose(
            tg[k], jg[k], atol=1e-2 * np.abs(jg[k]).max() + 1e-6,
            err_msg=k)
    print("gradient tree relative difference", _global_rel(jg, tg),
          "worst leaf", max(np.abs(tg[k] - jg[k]).max()
                            / (np.abs(jg[k]).max() + 1e-4) for k in jg))
    assert _global_rel(jg, tg) < 2e-3, _global_rel(jg, tg)


def test_apply_steps_match_jax(problem):
    """Two optimizer steps on the same gradients (NaN zeroing, global-norm
    clip, AdamW with weight decay 1e-5, the one-cycle rate at steps 0 and
    1): parameters within 1e-6 where a step moves them by up to 1e-3, and
    the reported norms within 1e-5 relative."""
    params = problem["params"]
    rng = np.random.default_rng(0)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), jnp.float32),
        params["params"])
    # one NaN element: zeroed before the clip, not spread by the norm
    bias = grads["fnet"]["conv1"]["bias"]
    grads["fnet"]["conv1"]["bias"] = bias.at[0].set(jnp.nan)

    cfg = JTrainConfig(image_size=(H, W), n_frames=N, steps=100, lr=1e-3)
    net = JDroidNet(dtype=None)
    tx = jts.make_optimizer(cfg)
    _, japply = jts.make_train_step(net, tx, iters=ITERS)
    jstate = jts.TrainState(params=jax.tree.map(jnp.array, params),
                            opt_state=tx.init(params["params"]),
                            step=jnp.zeros((), jnp.int32))
    tstate = _port_net(params)
    _, tapply = tts.make_train_step(iters=ITERS)
    tgrads = {k: v.clone() for k, v in convert.params_from_flax(
        jax.tree.map(np.asarray, grads)).items()}

    before = _flat(jax.tree.map(np.asarray, params["params"]))
    for step in range(2):
        jstate, jm = japply(jstate, jax.tree.map(jnp.array, grads))
        tm = tapply(tstate, {k: v.clone() for k, v in tgrads.items()})
        assert tstate.step == int(jstate.step) == step + 1
        want = _flat(jax.tree.map(np.asarray, jstate.params["params"]))
        got = _flat(convert.params_to_flax(
            tstate.net.state_dict())["params"])
        for k in want:
            np.testing.assert_allclose(got[k], want[k], atol=1e-6,
                                       err_msg=f"step {step} {k}")
        np.testing.assert_allclose(float(tm["param_norm"]),
                                   float(jm["param_norm"]), rtol=1e-5)
    moved = max(np.abs(want[k] - before[k]).max() for k in want)
    assert moved > 5e-4, moved
