"""Carry the JAX package's checkpoints over to the PyTorch modules.

The checkpoint is a tree of numpy arrays keyed like the flax param tree
(`fnet/layer1_0/conv1/kernel`, ...).  The torch modules use the same
names, so the mapping is mechanical in both directions: `kernel` (HWIO)
becomes `weight` (OIHW) and `bias` stays `bias`.  The flax tree declares
the delta/weight heads unfused (`delta_0`, `weight_0`, `delta_2`,
`weight_2`; the JAX package only fuses their kernels at run time), as the
torch modules do, so parameters and gradients of those heads map back
one to one.

The reference's published `droid.pth` is read too: `convert_state_dict`
maps its keys onto the same flax tree (the DDP `module.` prefix
stripped, the 3-channel delta and weight heads truncated to 2, as the
original `droid.py:45-58` does at load time), so there is one key map,
`params_from_flax`, from either file to the torch modules.
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


def to_numpy_state(state_dict):
    """A torch state_dict as {name: np.ndarray}, the DDP `module.` prefix
    stripped from every name."""
    out = {}
    for k, v in state_dict.items():
        if hasattr(v, "detach"):
            v = v.detach().cpu().numpy()
        out[k.replace("module.", "")] = np.asarray(v)
    return out


def _conv(sd, tname):
    """A torch conv's weight (OIHW) and bias -> {"kernel": HWIO, "bias"}."""
    w = sd[f"{tname}.weight"]
    entry = {"kernel": np.transpose(w, (2, 3, 1, 0))}
    if f"{tname}.bias" in sd:
        entry["bias"] = sd[f"{tname}.bias"]
    return entry


def _encoder(sd, prefix):
    params = {
        "conv1": _conv(sd, f"{prefix}.conv1"),
        "conv2": _conv(sd, f"{prefix}.conv2"),
    }
    for stage in (1, 2, 3):
        for blk in (0, 1):
            bp = f"{prefix}.layer{stage}.{blk}"
            entry = {
                "conv1": _conv(sd, f"{bp}.conv1"),
                "conv2": _conv(sd, f"{bp}.conv2"),
            }
            if f"{bp}.downsample.0.weight" in sd:
                entry["downsample"] = _conv(sd, f"{bp}.downsample.0")
            params[f"layer{stage}_{blk}"] = entry
    return params


def _truncate_head(entry, out_ch=2):
    """Keep the first `out_ch` output channels of a head (the published
    heads have 3, the model uses 2)."""
    entry = dict(entry)
    entry["kernel"] = entry["kernel"][..., :out_ch]
    if "bias" in entry:
        entry["bias"] = entry["bias"][:out_ch]
    return entry


def convert_state_dict(sd):
    """The reference's state_dict (numpy values, no `module.` prefix) ->
    the flax-layout param tree of DroidNet."""
    update = {
        "corr_encoder_0": _conv(sd, "update.corr_encoder.0"),
        "corr_encoder_2": _conv(sd, "update.corr_encoder.2"),
        "flow_encoder_0": _conv(sd, "update.flow_encoder.0"),
        "flow_encoder_2": _conv(sd, "update.flow_encoder.2"),
        "weight_0": _conv(sd, "update.weight.0"),
        "weight_2": _truncate_head(_conv(sd, "update.weight.2")),
        "delta_0": _conv(sd, "update.delta.0"),
        "delta_2": _truncate_head(_conv(sd, "update.delta.2")),
        "gru": {
            "convz": _conv(sd, "update.gru.convz"),
            "convr": _conv(sd, "update.gru.convr"),
            "convq": _conv(sd, "update.gru.convq"),
            "w": _conv(sd, "update.gru.w"),
            "convz_glo": _conv(sd, "update.gru.convz_glo"),
            "convr_glo": _conv(sd, "update.gru.convr_glo"),
            "convq_glo": _conv(sd, "update.gru.convq_glo"),
        },
        "agg": {
            "conv1": _conv(sd, "update.agg.conv1"),
            "conv2": _conv(sd, "update.agg.conv2"),
            "eta": _conv(sd, "update.agg.eta.0"),
            "upmask": _conv(sd, "update.agg.upmask.0"),
        },
    }
    return {"params": {"fnet": _encoder(sd, "fnet"),
                       "cnet": _encoder(sd, "cnet"),
                       "update": update}}


def load_reference_weights(path):
    """The reference's `droid.pth` as a flax-layout param tree."""
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return convert_state_dict(to_numpy_state(sd))


def load_weights(net, path):
    """Load a checkpoint into `net` (a DroidNet), read by extension: an
    `.npz` of this package or the JAX package, or the reference's `.pth`.
    Every array must be consumed and every module parameter provided."""
    path = str(path)
    if path.endswith(".npz"):
        tree = load_npz_weights(path)
    elif path.endswith(".pth"):
        tree = load_reference_weights(path)
    else:
        raise ValueError(f"{path}: weights must be an .npz or a .pth file")
    net.load_state_dict(params_from_flax(tree), strict=True)
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
