"""One rank of tests/test_torch_data_parallel.py's gloo run: joins the
process group from the environment torchrun would set, accumulates the
port's gradients on its slice of the batch, sums them across the ranks
and (rank 0) writes them to an npz file.  Imports no JAX."""

import os

import numpy as np
import torch


def batch_problem(B=2, N=4, H=64, W=96):
    """B box scenes (seeds 1..B) as a numpy batch and a temporal graph."""
    from droid_slam_tpu_torch.data.synthetic import render_box_scene
    from droid_slam_tpu_torch.geom.graph_utils import temporal_graph

    scs = [render_box_scene(N, H, W, seed=s + 1, motion_scale=0.08)
           for s in range(B)]
    batch = dict(
        images=np.stack([s["images"].astype(np.float32) for s in scs]),
        poses=np.stack([s["poses_c2w"] for s in scs]),
        disps=np.stack([1.0 / s["depths"] for s in scs]).astype(np.float32),
        intrinsics=np.stack([s["intrinsics"] for s in scs]))
    return batch, temporal_graph(N, r=1)


def port_gradients(batch_np, graph, weights, iters=2, cap=8):
    """The port's accumulate step on `batch_np` from `weights` (an npz);
    returns (gradient dict, metrics) after the sum over the ranks of the
    process group, if there is one."""
    from droid_slam_tpu_torch.config import TrainConfig
    from droid_slam_tpu_torch.models.convert import load_weights
    from droid_slam_tpu_torch.training import train_step as tts
    from droid_slam_tpu_torch.training.trainer import make_batch

    B, N, H, W = batch_np["images"].shape[:4]
    cfg = TrainConfig(image_size=(H, W), n_frames=N, steps=100)
    state = tts.create_train_state(cfg, 0, "cpu")
    load_weights(state.net, weights)
    batch = make_batch(batch_np, *graph, cap, "cpu")
    accum, _ = tts.make_train_step(iters=iters)
    grads, metrics = accum(tts.zero_grads(state.net), state.net, batch,
                           torch.zeros(B, N, 7),
                           torch.zeros(B, N, H // 8, W // 8))
    metrics = {k: v for k, v in metrics.items() if not k.startswith("_")}
    return tts.all_reduce_gradients(grads, metrics)


def run_rank(rank, world, port, weights, out):
    from droid_slam_tpu_torch.parallel.launch import (
        initialize_distributed, local_batch_slice)

    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    _, _, backend = initialize_distributed(device="cpu")
    assert backend == "gloo", backend
    batch_np, graph = batch_problem(B=world)
    sl = local_batch_slice(world)
    grads, metrics = port_gradients({k: v[sl] for k, v in batch_np.items()},
                                    graph, weights)
    if rank == 0:
        np.savez(out, **{k: v.numpy() for k, v in grads.items()},
                 **{"metric/" + k: v.numpy() for k, v in metrics.items()})
    torch.distributed.destroy_process_group()
