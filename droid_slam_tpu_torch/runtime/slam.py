"""Top-level SLAM system API.

Composition of the motion filter, frontend, backend and trajectory filler
over the shared keyframe map: `track()` per frame, `terminate()` for the
final trajectory (global-BA passes + trajectory fill).

Input is monocular RGB (H, W, 3), stereo (2, H, W, 3) [left, right]
under `SLAMConfig(stereo=True)`, or RGB with a metric depth map
(`track(..., depth=)`, RGB-D).  `SLAMConfig(upsample=True)` keeps the
keyframes' convex-upsampled full-resolution inverse depths in
`video.state.disps_up`.  `SLAMConfig(fused=False)` drives the keyframe
steps from the host-driven factor graph (runtime/frontend.py) instead of
the fused frontend's graph state (runtime/fused.py).
"""

import torch

from ..config import SLAMConfig
from ..lie import se3
from ..models.convert import load_weights
from ..models.droidnet import DroidNet, random_init
from .backend import Backend
from .frontend import Frontend
from .fused import FusedFrontend
from .motion_filter import MotionFilter
from .state import DepthVideo
from .trajectory_filler import TrajectoryFiller


def resolve_device(device=None):
    """`device`, defaulting to CUDA; raises when CUDA is asked for and no
    card is present (pass device="cpu" to run on the CPU)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device available; pass device='cpu' to "
                           "run on the CPU")
    return dev


class Droid:
    def __init__(self, config: SLAMConfig, weights_path=None, device=None,
                 seed=0):
        self.cfg = config
        self.device = resolve_device(device)
        # full-f32 matmuls and convolutions (cuDNN would use TF32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

        net = DroidNet()
        if weights_path is not None:
            load_weights(net, weights_path)
        else:
            random_init(net, seed)
        dtype = (torch.bfloat16 if config.compute_dtype == "bfloat16"
                 else torch.float32)
        self.net = net.to(device=self.device, dtype=dtype).eval()
        self.net.requires_grad_(False)

        self.video = DepthVideo(config, self.device)
        self.filter = MotionFilter(self.net, self.video,
                                   thresh=config.filter_thresh)
        frontend_cls = FusedFrontend if config.fused else Frontend
        self.frontend = frontend_cls(self.net, self.video, config)
        self.backend = Backend(self.net, self.video, config)
        self.traj_filler = TrajectoryFiller(self.net, self.video, config)

    def prewarm(self, chunk_sizes=()):
        """Build and load the CUDA kernels before the stream starts, so
        that no nvcc build lands mid-stream (nothing to do on the CPU).
        `chunk_sizes` is accepted for the JAX package's signature: eager
        PyTorch compiles nothing per chunk size."""
        if self.device.type == "cuda":
            from ..ops import cuda_build

            for name in cuda_build.source_names():
                cuda_build.load(name)

    @torch.no_grad()
    def track(self, tstamp, image, depth=None, intrinsics=None):
        """Ingest one frame: RGB (H, W, 3) uint8, or (2, H, W, 3) for a
        stereo config, with an optional (H, W) metric depth map; returns
        True when it passed the motion filter as a keyframe."""
        if self.cfg.fused and self.frontend.is_initialized:
            return self.frontend.track_frame(tstamp, image, depth,
                                             intrinsics)
        is_kf = self.filter.track(tstamp, image, depth, intrinsics)
        self.frontend()
        return is_kf

    @torch.no_grad()
    def track_batch(self, tstamps, images, intrinsics=None):
        """A chunk of frames without depth; encoders run once over the chunk
        once the fused frontend is initialized."""
        if self.cfg.fused and self.frontend.is_initialized:
            self.frontend.track_frames(tstamps, images, intrinsics)
        else:
            for t, im in zip(tstamps, images):
                self.track(t, im, intrinsics=intrinsics)

    @torch.no_grad()
    def terminate(self, stream=None, backend_steps=(7, 12)):
        """Global optimization + trajectory fill.

        Returns (n, 7) c2w poses [t, q] for every frame of `stream` (or the
        keyframe poses if no stream is given), as numpy.
        """
        del self.frontend
        for steps in backend_steps:
            self.backend(steps)
        if stream is not None:
            traj_w2c = torch.as_tensor(self.traj_filler(stream),
                                       device=self.device)
        else:
            traj_w2c = self.video.state.poses[: self.video.counter]
        return se3.inv(traj_w2c).cpu().numpy()
