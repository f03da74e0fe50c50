"""SLAM session snapshots: save a mapping session and resume it.

The keyframe map (every buffer of `VideoState` and the keyframe counter),
the frontend's factor graph (the fused frontend's `GraphState`, or the
host-driven frontend's `FactorGraph` under `fused=False`; its keyframe
count and whether it has booted) and the motion filter's last-keyframe
features go to one .npz, so a long session survives a restart and can
be inspected offline.  bf16 and f16 buffers are widened to float32 in
the file (npz has no bfloat16) and narrowed back on load, which restores
them exactly.  The files hold this package's state; they are not meant
to be read by the JAX package, nor its files by this one.
"""

import dataclasses

import numpy as np
import torch

from .fused import GraphState
from .state import VideoState

_GRAPH_ARRAYS = tuple(f.name for f in dataclasses.fields(GraphState)
                      if f.name not in ("ring_ptr", "tick"))
_FILTER = ("fmap", "knet", "kinp")
# the host-driven frontend's FactorGraph: host lists, then its stores
_HOST_LISTS = ("ii", "jj", "age", "slots", "ii_inac", "jj_inac")
_HOST_STORES = ("net_state", "target", "weight", "target_inac",
                "weight_inac")


def _to_np(x):
    """Tensor or array -> numpy, bf16/f16 widened to float32."""
    if isinstance(x, torch.Tensor):
        if x.dtype in (torch.bfloat16, torch.float16):
            x = x.float()
        return x.cpu().numpy()
    return np.asarray(x)


def save_session(path, droid):
    """Serialize a tracking Droid's map and frontend graph to `path`."""
    if not hasattr(droid, "frontend"):
        raise ValueError("this Droid has terminated; save the session "
                         "before terminate()")
    video, fe = droid.video, droid.frontend
    arrays = {f"video_{f.name}": _to_np(getattr(video.state, f.name))
              for f in dataclasses.fields(VideoState)}
    arrays["counter"] = np.asarray(video.counter)
    if droid.cfg.fused:
        arrays.update({f"graph_{k}": _to_np(getattr(fe.g, k))
                       for k in _GRAPH_ARRAYS})
        arrays["graph_ring_ptr"] = np.asarray(fe.g.ring_ptr)
        arrays["graph_tick"] = np.asarray(fe.g.tick)
    else:
        g = fe.graph
        arrays.update({f"host_{k}": _to_np(getattr(g, k))
                       for k in _HOST_LISTS + _HOST_STORES})
        arrays["host_free"] = np.asarray(g.free, np.int64)
        arrays["frontend_count"] = np.asarray(fe.count)
    arrays["frontend_t1"] = np.asarray(fe.t1)
    arrays["frontend_init"] = np.asarray(fe.is_initialized)
    if droid.filter.fmap is not None:
        arrays.update({f"filter_{k}": _to_np(getattr(droid.filter, k))
                       for k in _FILTER})
    np.savez_compressed(path, **arrays)
    return path


def _restore(dst, src):
    """Copy a saved array into a tensor or replace a numpy array, keeping
    the destination's dtype (and device); shapes must match."""
    if isinstance(dst, torch.Tensor):
        if tuple(src.shape) != tuple(dst.shape):
            raise ValueError(f"snapshot array of shape {src.shape} does not "
                             f"fit a buffer of shape {tuple(dst.shape)}; "
                             f"build the Droid with the saved config")
        dst.copy_(torch.from_numpy(src).to(dst.dtype))
        return dst
    return src.astype(dst.dtype)


def load_session(path, droid):
    """Restore a map and frontend graph saved by `save_session` into a
    Droid built with the same config; returns the Droid."""
    with np.load(path, allow_pickle=False) as data:
        video, fe = droid.video, droid.frontend
        for f in dataclasses.fields(VideoState):
            _restore(getattr(video.state, f.name), data[f"video_{f.name}"])
        video.counter = int(data["counter"])
        saved_fused = "graph_ii" in data
        if saved_fused != droid.cfg.fused:
            raise ValueError(f"the session was saved with fused="
                             f"{saved_fused}; build the Droid with it")
        if saved_fused:
            g = fe.g
            for k in _GRAPH_ARRAYS:
                setattr(g, k, _restore(getattr(g, k), data[f"graph_{k}"]))
            g.ring_ptr = int(data["graph_ring_ptr"])
            g.tick = int(data["graph_tick"])
        else:
            g = fe.graph
            for k in _HOST_LISTS:
                setattr(g, k, data[f"host_{k}"].astype(np.int64))
            for k in _HOST_STORES:       # the store may have grown
                a = torch.from_numpy(data[f"host_{k}"])
                setattr(g, k, a.to(g.dev, getattr(g, k).dtype))
            g.free = [int(x) for x in data["host_free"]]
            g.E_alloc = g.net_state.shape[0]
            fe.count = int(data["frontend_count"])
        fe.t1 = int(data["frontend_t1"])
        fe.is_initialized = bool(data["frontend_init"])
        # the motion filter's features, in the network's dtype
        dtype = next(droid.net.parameters()).dtype
        for k in _FILTER:
            if f"filter_{k}" in data:
                setattr(droid.filter, k, torch.from_numpy(
                    data[f"filter_{k}"]).to(video.device, dtype))
    return droid
