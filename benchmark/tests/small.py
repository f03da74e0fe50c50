"""Cells cut to a size the CPU runs in seconds: 96×128 tracking, 64×96
training with 4 frames and 2 unrolled iterations."""

import torch

from benchmark.lib import loader
from benchmark.run import run_cell

CPU = torch.device("cpu")
SEED = 2 ** 31 + 17


def track_override(workload, **slam):
    conf = loader.cell(loader.benchmark(), workload)[2]
    return dict(
        config={"slam": dict(conf["slam"], image_size=[96, 128], buffer=64,
                             **slam)},
        traffic={"frames": 90, "setup_frames": 30, "step_std": 0.3},
        workload={"sample": {"rounds": 2, "gates": 2, "keyframes": 3}})


def train_override():
    conf = loader.cell(loader.benchmark(), "train-tartanair.synth")[2]
    return dict(config={"train": dict(conf["train"], image_size=[64, 96],
                                      n_frames=4, iters=2, edges=8)},
                traffic={"scenes": 4, "scene_frames": 8})


def run_small(workload, seconds=4.0, control=False, **slam):
    torch.set_num_threads(4)
    over = (train_override() if workload.startswith("train")
            else track_override(workload, **slam))
    return run_cell(workload, SEED, seconds, 0, CPU, control=control,
                    override=over)
