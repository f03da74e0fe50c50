"""Data-parallel training of the PyTorch port.

* The port's accumulate step on a batch of 2 against the JAX package's
  on the same batch (batch > 1 had not run before): loss and metrics
  within 1e-4 relative, final poses 2e-5, disparities 2e-4, and the
  gradient tree within 2% of its norm — the bounds of
  tests/test_torch_train_step.py's batch-1 step.
* Two gloo processes on the CPU, a sample each (tests/torch_dp_worker.py),
  against one process: the summed gradient equals, bit for bit, the sum
  of the two samples' gradients taken in one process at the ranks'
  scale, and the loss averaged over the ranks is the batch's within 1e-5
  relative.  Against one process with both samples in one batch the
  gradient agrees within 1e-3 relative L2: splitting the batch alone
  moves it by 2.4e-4 on this problem (the CPU convolutions round
  differently at another batch size, and the unrolled BA amplifies it;
  two thread counts on the same batch differ by 1e-6), within the
  repository's bounds for two implementations of this step
  (tests/test_torch_train_step.py: 2e-3 of the norm).  Each rank
  differentiates its slice's loss over the world size, so `grad_clip`'s
  threshold meets the whole batch's gradients; averaging gradients
  taken at the slice's own scale instead misses by ~80% here.
"""

import multiprocessing
import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from droid_slam_tpu.config import TrainConfig as JTrainConfig
from droid_slam_tpu.models.convert import load_npz_weights as jload_npz
from droid_slam_tpu.models.droidnet import DroidNet as JDroidNet
from droid_slam_tpu.training import train_step as jts
from droid_slam_tpu_torch.models import convert
from droid_slam_tpu_torch.training import train_step as tts
from torch_dp_worker import batch_problem, port_gradients, run_rank
from torch_port_common import WEIGHTS

ITERS = 2


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: these small problems gain nothing from more,
    and the test run shares its cores between workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in convert._flatten(tree)}


def _global_rel(a, b):
    num = np.sqrt(sum(((a[k] - b[k]) ** 2).sum() for k in a))
    return num / np.sqrt(sum((a[k] ** 2).sum() for k in a))


def test_batch2_accumulate_matches_jax():
    batch_np, (ii, jj) = batch_problem(B=2)
    B, N, H, W = batch_np["images"].shape[:4]
    ii_p, jj_p, emask = tts.pad_edges(ii, jj, 8)
    jb = {k: jnp.asarray(v) for k, v in batch_np.items()}
    jb.update(disps=jnp.asarray(batch_np["disps"][:, :, 3::8, 3::8]),
              disps_full=jnp.asarray(batch_np["disps"]),
              ii=jnp.asarray(ii_p, jnp.int32), jj=jnp.asarray(jj_p, jnp.int32),
              edge_mask=jnp.asarray(emask))
    params = jax.tree.map(jnp.asarray, jload_npz(WEIGHTS))
    tx = jts.make_optimizer(JTrainConfig(image_size=(H, W), n_frames=N,
                                         steps=100))
    accum, _ = jts.make_train_step(JDroidNet(dtype=None), tx, iters=ITERS)
    jg, jm = accum(jax.tree.map(jnp.zeros_like, params["params"]), params,
                   jb, jnp.zeros((B, N, 7)),
                   jnp.zeros((B, N, H // 8, W // 8)))

    import droid_slam_tpu_torch.training.train_step as tstep
    from droid_slam_tpu_torch.config import TrainConfig
    from droid_slam_tpu_torch.training.trainer import make_batch

    state = tstep.create_train_state(
        TrainConfig(image_size=(H, W), n_frames=N, steps=100), 0, "cpu")
    convert.load_weights(state.net, WEIGHTS)
    taccum, _ = tstep.make_train_step(iters=ITERS)
    tg, tm = taccum(tstep.zero_grads(state.net), state.net,
                    make_batch(batch_np, ii, jj, 8, "cpu"),
                    torch.zeros(B, N, 7), torch.zeros(B, N, H // 8, W // 8))
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
    jflat = _flat(jg)
    tflat = _flat(convert.params_to_flax(tg)["params"])
    assert set(jflat) == set(tflat)
    assert _global_rel(jflat, tflat) < 0.02, _global_rel(jflat, tflat)


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_gloo_ranks_match_one_process(tmp_path, monkeypatch):
    """This test starts two processes; each join is bounded (240 s)."""
    out = str(tmp_path / "rank0.npz")
    ctx = multiprocessing.get_context("spawn")
    port = _free_port()
    procs = [ctx.Process(target=run_rank, args=(r, 2, port, WEIGHTS, out))
             for r in range(2)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=240)
            assert not p.is_alive(), "a rank did not finish in 240 s"
            assert p.exitcode == 0, p.exitcode
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()

    got = np.load(out)
    batch_np, graph = batch_problem(B=2)
    whole, metrics = port_gradients(batch_np, graph, WEIGHTS)
    np.testing.assert_allclose(float(got["metric/loss"]),
                               float(metrics["loss"]), rtol=1e-5)

    # the ranks' sum, in one process: each sample's loss over the world
    # size, no process group
    monkeypatch.setattr(tts, "world_size", lambda: 2)
    monkeypatch.setattr(tts, "all_reduce_gradients", lambda g, m: (g, m))
    halves = [port_gradients({k: v[i:i + 1] for k, v in batch_np.items()},
                             graph, WEIGHTS)[0] for i in range(2)]
    for k in whole:
        np.testing.assert_array_equal(
            got[k], (halves[0][k] + halves[1][k]).numpy(), err_msg=k)

    a = np.concatenate([whole[k].numpy().ravel() for k in whole])
    b = np.concatenate([got[k].ravel() for k in whole])
    rel = np.linalg.norm(b - a) / np.linalg.norm(a)
    assert rel < 1e-3, rel


def test_initialize_distributed_backend_choice(monkeypatch):
    """One process joins no group; ranks on the CPU would get gloo, and
    asking NCCL for them (also through train's --dist_backend) raises
    before any group is formed."""
    from droid_slam_tpu_torch import train
    from droid_slam_tpu_torch.parallel import launch

    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert launch.initialize_distributed(device="cpu") == (0, 1, None)
    assert launch.local_batch_slice(4) == slice(0, 4)
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="NCCL needs a card per rank"):
        launch.initialize_distributed(device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="NCCL needs a card per rank"):
        train.main(["--synthetic", "--device", "cpu", "--batch", "2",
                    "--dist_backend", "nccl"])
    assert not torch.distributed.is_initialized()
