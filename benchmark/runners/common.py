"""What the runners share: the device's clock, its memory peak, and the
numbers a check compares."""

import time

import torch


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def now_ns():
    return time.perf_counter_ns()


def memory_peak(device):
    return (int(torch.cuda.max_memory_allocated(device))
            if device.type == "cuda" else 0)


def reset_peak(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)


def free(device):
    if device.type == "cuda":
        torch.cuda.empty_cache()


def rel_gap(a, b):
    """‖a − b‖ / ‖b‖ in float32."""
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm().clamp(min=1e-12))


def compared(name, value, limits):
    """One compared number: dict(name, value, limit); a number without a
    limit fails."""
    limit = limits.get(name)
    return dict(name=name, value=float(value), limit=limit)
