"""Carry the JAX package's checkpoints over to the PyTorch modules.

The checkpoint is a tree of numpy arrays keyed like the flax param tree
(`fnet/layer1_0/conv1/kernel`, ...).  The torch modules use the same
names, so the mapping is mechanical in both directions: `kernel` (HWIO)
becomes `weight` (OIHW) and `bias` stays `bias`.  The flax tree declares
the delta/weight heads unfused (`delta_0`, `weight_0`, `delta_2`,
`weight_2`; the JAX package only fuses their kernels at run time), as the
torch modules do, so parameters and gradients of those heads map back
one to one.
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


def params_to_flax(named):
    """The inverse of `params_from_flax`: a mapping of torch names
    (`net.state_dict()`, or gradients keyed like `named_parameters()`) to
    tensors -> {"params": flax-layout tree of float32 numpy arrays}."""
    tree = {}
    for name, ten in named.items():
        *mod, leaf = name.split(".")
        arr = ten.detach().float().cpu().numpy()
        node = tree
        for p in mod:
            node = node.setdefault(p, {})
        if leaf == "weight":
            node["kernel"] = np.ascontiguousarray(arr.transpose(2, 3, 1, 0))
        elif leaf == "bias":
            node["bias"] = arr.copy()
        else:
            raise KeyError(f"unexpected parameter name {name}")
    return {"params": tree}


def save_npz_weights(net, path):
    """Export `net`'s parameters as a compressed npz with slash-joined
    flax keys, the format `load_npz_weights` (here and in the JAX
    package) reads.  Returns the number of arrays written."""
    flat = {"/".join(k): v
            for k, v in _flatten(params_to_flax(net.state_dict())["params"])}
    np.savez_compressed(path, **flat)
    return len(flat)
