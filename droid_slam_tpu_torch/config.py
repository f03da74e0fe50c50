"""Configuration for the SLAM runtime and for training.

The fields and presets of the JAX package's `SLAMConfig`, less two that
only its runtime reads: `lookup_impl` (the port has no implementation
switch: CUDA tensors go through the hand-written lookup kernel, CPU
tensors through its plain PyTorch version, ops/corr.py) and
`schur_degree_cap` (the port's dense BA builds each depth frame's Schur
terms from the edges that leave it, by index, with no per-frame degree
table to size, ops/dba.py).
"""

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SLAMConfig:
    # --- geometry / buffers -------------------------------------------------
    image_size: Tuple[int, int] = (240, 320)   # input H, W (multiple of 8)
    buffer: int = 512                          # max keyframes
    stereo: bool = False
    upsample: bool = False

    # --- motion filter ------------------------------------------------------
    filter_thresh: float = 2.4                 # mean-flow keyframe gate

    # --- frontend -----------------------------------------------------------
    warmup: int = 8
    keyframe_thresh: float = 4.0
    frontend_thresh: float = 16.0
    frontend_window: int = 25
    frontend_radius: int = 2
    frontend_nms: int = 1
    max_age: int = 25
    frontend_iters1: int = 4
    frontend_iters2: int = 2
    frontend_max_factors: int = 48

    # --- backend ------------------------------------------------------------
    backend_thresh: float = 22.0
    backend_radius: int = 2
    backend_nms: int = 3
    beta: float = 0.3

    # --- BA solver ----------------------------------------------------------
    frontend_lm: float = 1e-4
    frontend_ep: float = 0.1
    backend_lm: float = 1e-5
    backend_ep: float = 1e-2
    ba_iters: int = 2                          # inner GN iterations per update

    # --- capacities ---------------------------------------------------------
    # active + inactive edge capacity of the boot factor graph
    frontend_edge_cap: int = 96
    # pose window capacity of the boot-graph BA (frames in [t0, t1))
    frontend_pose_cap: int = 64
    # depth-frame capacity of the boot-graph BA (kx = window ∪ {ii})
    frontend_depth_cap: int = 64
    # trajectory filler batch
    filler_batch: int = 16
    # per-keyframe frontend step on the fused graph state
    # (runtime/fused.py); False drives it from the host factor graph
    # (runtime/frontend.py)
    fused: bool = True
    # route the backend's global BA through the edge-sharded solver
    # (parallel/dba.py) when the BA mesh has more than one device
    distributed_backend: bool = False
    # low-memory on-the-fly correlation: query pixels per volume block
    # (0 = auto: chunk only when the level-0 volume would exceed ~0.6 GB)
    corr_pixel_chunk: int = 0
    # cache the per-edge correlation-volume pyramid across a keyframe's
    # 4+2 update rounds when it fits this budget (MB; 0 disables)
    corr_cache_mb: int = 512

    # --- precision ----------------------------------------------------------
    compute_dtype: str = "bfloat16"            # network compute


# Per-dataset presets mirroring the reference evaluation scripts' defaults.
PRESETS = {
    "tum": SLAMConfig(
        image_size=(240, 320), buffer=512, beta=0.6, filter_thresh=1.75,
        warmup=12, keyframe_thresh=2.25, frontend_thresh=12.0,
        frontend_window=25, frontend_radius=2, frontend_nms=1,
        backend_thresh=15.0, backend_radius=2, backend_nms=3,
    ),
    "euroc": SLAMConfig(
        image_size=(320, 512), buffer=512, beta=0.3, filter_thresh=2.4,
        warmup=15, keyframe_thresh=3.5, frontend_thresh=17.5,
        frontend_window=20, frontend_radius=2, frontend_nms=1,
        backend_thresh=24.0, backend_radius=2, backend_nms=2,
    ),
    "eth3d": SLAMConfig(
        image_size=(240, 320), buffer=1024, beta=0.5, filter_thresh=2.0,
        warmup=8, keyframe_thresh=3.5, frontend_thresh=16.0,
        frontend_window=16, frontend_radius=1, frontend_nms=0,
        backend_thresh=22.0, backend_radius=2, backend_nms=3,
    ),
    "tartanair": SLAMConfig(
        image_size=(384, 512), buffer=1000, beta=0.3, filter_thresh=2.4,
        warmup=12, keyframe_thresh=3.5, frontend_thresh=15.0,
        frontend_window=20, frontend_radius=1, frontend_nms=1,
        backend_thresh=20.0, backend_radius=2, backend_nms=3,
    ),
    "demo": SLAMConfig(),
}


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """Training hyperparameters: the JAX package's `TrainConfig`, less the
    fields nothing in this package reads (`noise`, `scale`) and
    `world_size`: the JAX trainer builds its mesh from that field, while
    this one reads the size of the process group that torchrun started
    (parallel/launch.world_size).  `fmin` and `fmax` bound the flow
    (pixels) between consecutive frames of a TartanAir sample's walk.
    `batch` is the global batch, shared by the data-parallel ranks."""

    lr: float = 2.5e-4
    steps: int = 250000
    batch: int = 1
    iters: int = 15                 # unrolled update steps
    clip: float = 2.5
    n_frames: int = 7
    fmin: float = 8.0
    fmax: float = 96.0
    edges: int = 24
    restart_prob: float = 0.2
    ckpt_every: int = 10000
    image_size: Tuple[int, int] = (384, 512)
    fix_scale: bool = True
    ckpt_dir: str = "checkpoints"
    name: str = "droid_torch"
