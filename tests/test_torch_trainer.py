"""The port's training loop on the CPU at a small size: the loss falls on
one batch, checkpoints round-trip, `train` runs end to end from the
synthetic curriculum and exports weights the JAX package reads."""

import numpy as np
import pytest
import torch

from droid_slam_tpu.models.convert import load_npz_weights as jload_npz
from droid_slam_tpu_torch.config import TrainConfig
from droid_slam_tpu_torch.data.synthetic import (SyntheticCurriculum,
                                                 render_plane_scene)
from droid_slam_tpu_torch.geom.graph_utils import temporal_graph
from droid_slam_tpu_torch.models import convert
from droid_slam_tpu_torch.training import train_step as tts
from droid_slam_tpu_torch.training import trainer
from torch_port_common import WEIGHTS


def _one_batch(N, H, W, cap, r=1):
    data = render_plane_scene(8, H, W, seed=0)
    batch_np = dict(images=data["images"][:N].astype(np.float32)[None],
                    poses=data["poses_c2w"][:N][None],
                    disps=(1.0 / data["depths"][:N])[None],
                    intrinsics=data["intrinsics"][:N][None])
    ii, jj = temporal_graph(N, r=r)
    return trainer.make_batch(batch_np, ii, jj, cap, "cpu")


def _step(state, accum, apply_g, batch, N, H, W):
    grads, metrics = accum(tts.zero_grads(state.net), state.net, batch,
                           torch.zeros(1, N, 7),
                           torch.zeros(1, N, H // 8, W // 8))
    metrics.update(apply_g(state, grads))
    return metrics


def test_loss_decreases():
    """Eight steps on one synthetic batch from a seeded initialisation
    reduce the loss (the JAX package's own check, same sizes)."""
    torch.set_num_threads(2)
    N, H, W = 4, 64, 96
    cfg = TrainConfig(image_size=(H, W), n_frames=N, steps=100, lr=2e-5)
    state = tts.create_train_state(cfg, seed=0, device="cpu")
    accum, apply_g = tts.make_train_step(iters=2)
    batch = _one_batch(N, H, W, cap=8)
    losses = []
    for _ in range(8):
        m = _step(state, accum, apply_g, batch, N, H, W)
        losses.append(float(m["loss"]))
        assert np.isfinite(float(m["grad_norm"]))
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < losses[0], losses
    assert state.step == 8


def test_remat_gives_the_same_gradients():
    """Recomputing each iteration in the backward pass changes no value:
    loss equal, gradients equal to f32 rounding (1e-6 of their scale)."""
    torch.set_num_threads(2)
    N, H, W = 3, 32, 48
    cfg = TrainConfig(image_size=(H, W), n_frames=N, steps=100)
    state = tts.create_train_state(cfg, seed=1, device="cpu")
    convert.load_weights(state.net, WEIGHTS)
    batch = _one_batch(N, H, W, cap=8)
    out = []
    for remat in (False, True):
        accum, _ = tts.make_train_step(iters=2, remat=remat)
        g, m = accum(tts.zero_grads(state.net), state.net, batch,
                     torch.zeros(1, N, 7), torch.zeros(1, N, H // 8, W // 8))
        out.append((float(m["loss"]), g))
    assert out[0][0] == out[1][0]
    for k, a in out[0][1].items():
        np.testing.assert_allclose(out[1][1][k].numpy(), a.numpy(),
                                   atol=1e-6 * float(a.abs().max()) + 1e-9)


def test_checkpoint_roundtrip(tmp_path):
    """Parameters, optimizer moments and the step count survive
    save_checkpoint / restore_checkpoint exactly."""
    torch.set_num_threads(2)
    N, H, W = 3, 32, 32
    cfg = TrainConfig(image_size=(H, W), n_frames=N, steps=10)
    state = tts.create_train_state(cfg, seed=0, device="cpu")
    accum, apply_g = tts.make_train_step(iters=1)
    _step(state, accum, apply_g, _one_batch(N, H, W, cap=8), N, H, W)
    state.step = 7
    path = trainer.save_checkpoint(str(tmp_path), state, 7)

    other = tts.create_train_state(cfg, seed=5, device="cpu")
    trainer.restore_checkpoint(path, other)
    assert other.step == 7
    for (k, a), (_, b) in zip(state.net.state_dict().items(),
                              other.net.state_dict().items()):
        assert torch.equal(a, b), k
    sa, sb = state.opt.state_dict(), other.opt.state_dict()
    assert sa["param_groups"] == sb["param_groups"]
    for i, st in sa["state"].items():
        for name, v in st.items():
            assert torch.equal(torch.as_tensor(v),
                               torch.as_tensor(sb["state"][i][name])), name


def test_train_runs_and_exports_npz(tmp_path, capsys):
    """`train` over the synthetic curriculum for three steps (restart
    chains on), a warm start from the shipped npz, a resume from the
    final checkpoint, and an npz export that the JAX package's loader
    reads back as the same tree."""
    torch.set_num_threads(2)
    cfg = TrainConfig(image_size=(64, 96), n_frames=4, steps=100, iters=2,
                      edges=8, lr=2e-5, restart_prob=0.5,
                      ckpt_dir=str(tmp_path / "ck"), name="t")
    ds = SyntheticCurriculum(cfg, n_scenes=3)
    assert len(ds) == 3
    kw = dict(device="cpu", log_every=1, log_dir=str(tmp_path / "runs"))
    state = trainer.train(cfg, ds, max_steps=3, init_npz=WEIGHTS, **kw)
    assert state.step == 3
    out = capsys.readouterr().out
    assert "warm-started" in out and "step 3:" in out
    assert (tmp_path / "runs" / "t" / "metrics.jsonl").read_text().strip()
    final = tmp_path / "ck" / "step_000003.pt"
    assert final.exists()

    resumed = trainer.train(cfg, ds, max_steps=4, resume=str(final), **kw)
    assert resumed.step == 4
    assert (tmp_path / "ck" / "step_000004.pt").exists()

    npz = str(tmp_path / "w.npz")
    assert convert.save_npz_weights(resumed.net, npz) == 102
    tree = jload_npz(npz)["params"]
    want = convert.params_to_flax(resumed.net.state_dict())["params"]
    flat_w = dict(convert._flatten(want))
    flat_g = dict(convert._flatten(tree))
    assert set(flat_w) == set(flat_g)
    for k in flat_w:
        np.testing.assert_array_equal(flat_g[k], flat_w[k])
    # and the shipped tree has the same layout
    assert set(flat_w) == set(dict(convert._flatten(
        jload_npz(WEIGHTS)["params"])))


def test_train_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = TrainConfig(image_size=(32, 48), n_frames=3, steps=10)
    with pytest.raises(RuntimeError, match="CUDA"):
        trainer.train(cfg, dataset=None)


def test_create_train_state_defaults_to_the_card():
    """Without `device`, the train state goes to the CUDA card, as `Droid`
    and `train` do: on a machine without one it raises instead of falling
    back to the CPU."""
    cfg = TrainConfig(image_size=(32, 48), n_frames=3, steps=10)
    if torch.cuda.is_available():
        state = tts.create_train_state(cfg)
        assert next(state.net.parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tts.create_train_state(cfg)


def test_pad_edges_and_capacity():
    ii, jj, m = tts.pad_edges([1, 2, 3], [0, 1, 2], 8)
    assert ii.tolist() == [1, 2, 3, 0, 0, 0, 0, 0] and m.sum() == 3
    assert jj.tolist() == [0, 1, 2, 0, 0, 0, 0, 0]
    with pytest.warns(UserWarning, match="truncating"):
        ii, jj, m = tts.pad_edges(np.arange(10), np.arange(10), 8)
    assert len(ii) == 8 and m.all()
    assert trainer.edge_capacity(TrainConfig()) == 40
