"""Process groups and device lists for data-parallel training and the
distributed global BA.

Data-parallel training runs one process per rank under
`python -m torch.distributed.run --nproc_per_node N -m
droid_slam_tpu_torch.train ...`, which sets RANK, WORLD_SIZE, LOCAL_RANK,
LOCAL_WORLD_SIZE, MASTER_ADDR and MASTER_PORT; `initialize_distributed`
reads them and joins the group (a single process joins nothing).  The
distributed BA needs no process group: one process drives a list of
devices (`ba_mesh`).
"""

import os

import torch


def _env_int(name, default):
    return int(os.environ.get(name, default))


def world_size():
    """Ranks of the default process group (1 without one)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def rank():
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def data_mesh(device=None):
    """This rank's device: `device` when given, else the card
    LOCAL_RANK % (visible cards); raises without a card."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    return torch.device("cuda", _env_int("LOCAL_RANK", 0)
                        % torch.cuda.device_count())


def initialize_distributed(device=None, backend=None):
    """Join the process group torchrun describes, or nothing when
    WORLD_SIZE is unset or 1.  Returns (rank, world size, backend).

    The backend follows the ranks' devices: NCCL when each local rank has
    a card of its own, gloo on the CPU or when local ranks share a card
    (NCCL refuses two ranks on one device; gloo's all-reduce takes the
    CUDA tensors, so the gradients stay on the card).  Asking for NCCL
    with shared cards raises.
    """
    import torch.distributed as dist

    world = _env_int("WORLD_SIZE", 1)
    if world == 1:
        return 0, 1, None
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.get_backend()
    dev = data_mesh(device)
    local_world = _env_int("LOCAL_WORLD_SIZE", world)
    shared = dev.type == "cuda" and local_world > torch.cuda.device_count()
    if backend is None:
        backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    if backend == "nccl" and (shared or dev.type != "cuda"):
        raise ValueError(f"NCCL needs a card per rank: {local_world} local "
                         f"ranks on {dev}")
    r = _env_int("RANK", 0)
    addr = os.environ.get("MASTER_ADDR", "localhost")
    port = os.environ.get("MASTER_PORT", "29500")
    if dev.type == "cuda" and dev.index is not None:
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=f"tcp://{addr}:{port}",
                            rank=r, world_size=world)
    print(f"distributed: rank {r} of {world}, backend {backend}, device "
          f"{dev}", flush=True)
    return r, world, backend


def ba_mesh(devices=None):
    """Devices for the shards of the distributed BA: `devices`, or every
    visible card (none without one)."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    return [torch.device(d) for d in devices]


def local_batch_slice(global_batch):
    """This rank's slice of a global batch axis of length global_batch."""
    world = world_size()
    if global_batch % world:
        raise ValueError(f"batch {global_batch} does not divide by the "
                         f"world size {world}")
    per = global_batch // world
    return slice(rank() * per, (rank() + 1) * per)
