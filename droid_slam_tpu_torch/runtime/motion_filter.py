"""Keyframe gating before the frontend is initialized.

Every incoming frame is encoded (fnet); the flow magnitude against the
last keyframe is estimated with one update-operator step on the
correlation of the two feature maps; frames whose mean |delta| exceeds
the threshold become keyframes (context features are computed only then).
A stereo frame (2, H, W, 3) stores the features of both cameras; the gate
and the context features read the left one.  Sensor depth passes through
to the keyframe.
"""

import torch

from ..geom import projective
from ..models.droidnet import normalize_images
from ..ops import corr as corr_ops
from ..utils.timers import span, sync_site


def as_image_batch(image, device):
    """(H, W, 3) or (rig, H, W, 3) uint8 image(s) -> (rig, H, W, 3)
    contiguous tensor on `device` (the network's result must not depend
    on the memory layout of the caller's array)."""
    with sync_site("h2d.image"):
        image = torch.as_tensor(image).to(device).contiguous()
    return image[None] if image.ndim == 3 else image


class MotionFilter:
    def __init__(self, net, video, thresh=2.4):
        """net: DroidNet; video: DepthVideo."""
        self.net = net
        self.video = video
        self.thresh = thresh

        # last-keyframe features
        self.fmap = None    # (rig, h, w, 128)
        self.knet = None    # (h, w, 128)
        self.kinp = None    # (h, w, 128)

    def encode(self, images):
        """(rig, H, W, 3) RGB -> fmaps (rig, h, w, 128)."""
        return self.net.fnet(normalize_images(images))

    def context(self, image):
        """(H, W, 3) -> (net, inp) context features (h, w, 128)."""
        net, inp = self.net.context(normalize_images(image[None]))
        return net[0], inp[0]

    def delta(self, kf_fmap, fmap, knet, kinp):
        """Mean flow-update magnitude between the last keyframe and this
        frame: 1-edge correlation pyramid + one update step."""
        f1 = kf_fmap[None, None].float()
        f2 = fmap[None, None].float()
        pyramid = corr_ops.build_pyramid(corr_ops.corr_volume(f1, f2))
        ht, wd = kf_fmap.shape[0], kf_fmap.shape[1]
        coords0 = projective.coords_grid(ht, wd, device=f1.device)
        corr = corr_ops.lookup_pyramid(pyramid, coords0[None, None],
                                       impl="flat")
        _, delta, _ = self.net.update(knet[None], kinp[None], corr[0])
        return torch.mean(torch.linalg.norm(delta, dim=-1))

    @torch.no_grad()
    def track(self, tstamp, image, depth=None, intrinsics=None):
        """Returns True when the frame became a keyframe."""
        image = as_image_batch(image, self.video.device)
        with span("filter.encode"):
            fmap = self.encode(image)
        intr8 = torch.as_tensor(intrinsics, dtype=torch.float32) / 8.0

        if self.video.counter == 0:
            pose = torch.tensor([0, 0, 0, 0, 0, 0, 1.0])
        else:
            # the gate is a host read: it waits for the encoder too
            with span("filter.gate"):
                d = self.delta(self.fmap[0], fmap[0], self.knet, self.kinp)
                with sync_site("filter.item"):
                    d = float(d)
            if not d > self.thresh:
                return False
            pose = None
        knet, kinp = self.context(image[0])
        self.fmap, self.knet, self.kinp = fmap, knet, kinp
        self.video.append(tstamp, pose, None, depth, intr8,
                          fmap.to(torch.bfloat16), knet, kinp, image=image)
        return True
