"""Read a weights file the port ships (an npz in the flax layout:
`fnet/layer1_0/conv1/kernel` HWIO, `.../bias`) into the reference
network."""

import numpy as np
import torch

from .droidnet import DroidNet


def state_dict_from_npz(path):
    sd = {}
    with np.load(path) as data:
        for key in data.files:
            parts = key.split("/")
            if parts[0] == "params":
                parts = parts[1:]
            *mod, leaf = parts
            arr = np.asarray(data[key], np.float32)
            if leaf == "kernel":
                sd[".".join(mod) + ".weight"] = torch.from_numpy(
                    np.ascontiguousarray(arr.transpose(3, 2, 0, 1)))
            elif leaf == "bias":
                sd[".".join(mod) + ".bias"] = torch.from_numpy(arr.copy())
            else:
                raise KeyError(f"unexpected parameter leaf {key}")
    return sd


def load_net(path, device):
    """The reference DroidNet in float32 on `device`, weights from `path`."""
    net = DroidNet()
    net.load_state_dict(state_dict_from_npz(path), strict=True)
    return net.to(device).float()
