"""DroidNet, inference half: feature/context encoders + update operator.

Images are RGB in [0, 255]; ImageNet normalization is applied here.  The
training forward (unrolled updates with differentiable BA) is not ported.
"""

import torch
from torch import nn

from .extractor import BasicEncoder
from .update import UpdateModule

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)


def normalize_images(images):
    """(..., H, W, 3) RGB in [0,255] -> ImageNet-normalized float32."""
    x = images.float() / 255.0
    mean = x.new_tensor(IMAGENET_MEAN)
    std = x.new_tensor(IMAGENET_STD)
    return (x - mean) / std


class DroidNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.fnet = BasicEncoder(output_dim=128, norm_fn="instance")
        self.cnet = BasicEncoder(output_dim=256, norm_fn="none")
        self.update = UpdateModule()

    def context(self, x):
        """Normalized images (..., H, W, 3) -> (net, inp) = (tanh, relu)
        halves of the context features, (..., h, w, 128) each."""
        ctx = self.cnet(x)
        net, inp = ctx.split(128, dim=-1)
        return torch.tanh(net), torch.relu(inp)
