"""Carry the JAX package's checkpoints over to the PyTorch modules.

The checkpoint is a tree of numpy arrays keyed like the flax param tree
(`fnet/layer1_0/conv1/kernel`, ...).  The torch modules use the same
names, so the mapping is mechanical: `kernel` (HWIO) becomes `weight`
(OIHW) and `bias` stays `bias`.
"""

import numpy as np
import torch


def load_npz_weights(path):
    """Read a params npz (slash-joined keys) into a nested dict tree."""
    tree = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            node = tree
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return tree


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_flax(tree):
    """Flax-layout param tree (numpy leaves) -> torch state_dict.

    Accepts the tree with or without the top-level "params" key.
    """
    if "params" in tree and isinstance(tree["params"], dict):
        tree = tree["params"]
    sd = {}
    for path, arr in _flatten(tree):
        arr = np.asarray(arr, np.float32)
        *mod, leaf = path
        if leaf == "kernel":
            sd[".".join(mod) + ".weight"] = torch.from_numpy(
                np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
        elif leaf == "bias":
            sd[".".join(mod) + ".bias"] = torch.from_numpy(arr.copy())
        else:
            raise KeyError(f"unexpected parameter leaf {'/'.join(path)}")
    return sd


def load_weights(net, path):
    """Load an npz checkpoint into `net` (a DroidNet); every array must be
    consumed and every module parameter provided."""
    net.load_state_dict(params_from_flax(load_npz_weights(path)),
                        strict=True)
    return net
