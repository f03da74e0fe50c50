"""Where the PyTorch port's training step goes on a CUDA card.

    python tools/torch_profile_train.py

Builds one batch of the synthetic curriculum at the full width of
`TrainConfig()` (384x512, 7 frames, 15 iterations, 40 edge slots, f32),
runs one accumulate + apply step unprofiled (kernel build, cuDNN
autotuning) and a second one under torch.profiler, from a seeded
initialisation with the "level" lookup.  Prints one JSON line:

  * window_ms: host time of the profiled step (ends in a synchronize);
  * device_busy_ms / device_span_ms / device_idle_share / launches / top /
    lookup (device time of the three lookup kernels in the step): as
    tools/torch_profile_track.py reports them.

The profiler's own overhead stretches the host side, so window_ms and the
idle share are upper bounds of the unprofiled run's.  Needs a CUDA card.
"""

import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from torch_profile_track import device_summary  # noqa: E402


def main():
    if not torch.cuda.is_available():
        print("torch_profile_train: no CUDA device", file=sys.stderr)
        return 1

    from droid_slam_tpu_torch.config import TrainConfig
    from droid_slam_tpu_torch.data.synthetic import SyntheticCurriculum
    from droid_slam_tpu_torch.geom.graph_utils import temporal_graph
    from droid_slam_tpu_torch.ops import corr
    from droid_slam_tpu_torch.training import train_step as tts
    from droid_slam_tpu_torch.training.trainer import (edge_capacity,
                                                       make_batch)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    corr.set_lookup_impl("level")
    cfg = TrainConfig()
    N = cfg.n_frames
    dataset = SyntheticCurriculum(cfg, n_scenes=1)
    batch_np = next(dataset.sample_batches(cfg.batch,
                                           rng=np.random.default_rng(7)))
    batch = make_batch(batch_np, *temporal_graph(N, r=2),
                       edge_capacity(cfg), "cuda")
    h8, w8 = batch["disps"].shape[-2:]
    Gs0 = torch.zeros((cfg.batch, N, 7), device="cuda")
    disp0 = torch.zeros((cfg.batch, N, h8, w8), device="cuda")
    state = tts.create_train_state(cfg, seed=0, device="cuda")
    accum, apply_g = tts.make_train_step(iters=cfg.iters,
                                         fix_scale=cfg.fix_scale)

    def step():
        grads, m = accum(tts.zero_grads(state.net), state.net, batch, Gs0,
                         disp0)
        m.update(apply_g(state, grads))
        torch.cuda.synchronize()
        return float(m["loss"])

    step()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.time()
        loss = step()
        window_ms = (time.time() - t) * 1e3

    summary = device_summary(prof)
    out = dict(device=torch.cuda.get_device_name(0), loss=loss,
               window_ms=window_ms, **summary)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
