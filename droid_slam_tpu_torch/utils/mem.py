"""Device-memory readings of the caching allocator.

`device_mem_stats` reads `torch.cuda.memory_stats` and `mem_get_info`;
on a CPU device every value is None.  `log_mem` prints one line of them
when the environment sets DROID_MEM_LOG.
"""

import os
import sys

import torch


def device_mem_stats(device=None):
    """(bytes allocated, peak bytes allocated, the card's total bytes) of
    `device` (the current CUDA device by default), or three Nones on a
    CPU device or without a card."""
    if device is None:
        if not torch.cuda.is_available():
            return None, None, None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None, None, None
    stats = torch.cuda.memory_stats(device)
    _, total = torch.cuda.mem_get_info(device)
    return (stats.get("allocated_bytes.all.current"),
            stats.get("allocated_bytes.all.peak"), total)


def log_mem(tag, device=None):
    """One line of allocator state on stderr when DROID_MEM_LOG is set."""
    if not os.environ.get("DROID_MEM_LOG"):
        return
    use, peak, lim = device_mem_stats(device)

    def gb(b):
        return f"{b / 1e9:.2f}" if b is not None else "?"

    print(f"[mem] {tag}: in_use={gb(use)} GB peak={gb(peak)} GB "
          f"limit={gb(lim)} GB", file=sys.stderr, flush=True)
