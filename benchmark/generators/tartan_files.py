"""Training traffic read from files: the curriculum's scene families
(curriculum.py), rendered on the device at TartanAir's 480x640 with the
reader's fixed calibration (fx = fy = 320, c = (320, 240):
`droid_slam_tpu_torch.data.tartan.TartanAir.calib_read`), written in
TartanAir's layout under a temporary directory of the run, and read back
by the port's own reader, `data/tartan.TartanAir`, with its augmentation
and its frame-graph walks.

Layout, scene s: `<root>/<env>/<env>/Easy/P<sss>/` with
`image_left/<n>_left.png` (through `data/image_io.write_png`),
`depth_left/<n>_left_depth.npy` (z-depth times DEPTH_SCALE, metres as
the reader takes them) and `pose_left.txt` (camera-to-world [t, q],
translations times DEPTH_SCALE, in NED order).  Each scene's frames get
one draw of the curriculum's photometric jitter (gain, bias, gamma) and
a per-frame sensor noise before they are written.

Parameters (the traffic file): curriculum.py's (`focals` holds the one
focal, 0.5 of the width), the image size `image_size` [H, W] the files
are written at, and the reader's `fmin`/`fmax` flow bounds.  The frame
graph's cache lives beside the files, and both go when the dataset is
collected or the process ends.

No cell of BENCHMARK.json runs it yet: on these files the training
check's ratios do not separate the program from its control and faults
(PERF.md §6).
"""

import os
import shutil
import tempfile
import weakref
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from benchmark.generators.curriculum import _scene
from benchmark.generators.scenes import generators

DEPTH_SCALE = 5.0
# inverse of the reader's NED permutation [1, 2, 0, 4, 5, 3, 6]
NED_INVERSE = [2, 0, 1, 5, 3, 4, 6]
ENVS = ("boxroom", "boxroom_b", "occluders", "corridor", "wall",
        "slanted_wall")


def _jitter(images, rng, gen, p):
    """The scene's frames (T, H, W, 3) uint8 with one photometric draw and
    per-frame sensor noise, as uint8 numpy."""
    img = images.float() / 255.0
    img = (255.0 * img.clamp(0, 1) ** rng.uniform(*p["gamma"])
           * rng.uniform(*p["gain"]) + rng.uniform(*p["bias"]))
    sigma = torch.as_tensor(rng.uniform(0, p["noise"], len(img)),
                            dtype=torch.float32, device=img.device)
    img = img + sigma[:, None, None, None] * torch.randn(
        img.shape, generator=gen, device=img.device)
    return img.round().clamp(0, 255).to(torch.uint8).cpu().numpy()


def write_scenes(root, params, seed, device):
    """Render and write the traffic's scenes under `root`; returns their
    directories."""
    from droid_slam_tpu_torch.data.image_io import write_png

    H, W = params["image_size"]
    rng, gen = generators(seed, device)
    dirs = []
    with ThreadPoolExecutor(max_workers=8) as pool:
        jobs = []
        for s in range(params["scenes"]):
            sc = _scene(s, rng, gen, params, H, W, device)
            env = ENVS[s % len(ENVS)]
            d = os.path.join(root, env, env, "Easy", f"P{s:03d}")
            for sub in ("image_left", "depth_left"):
                os.makedirs(os.path.join(d, sub), exist_ok=True)
            images = _jitter(sc["images"], rng, gen, params)
            depths = (sc["depths"] * DEPTH_SCALE).cpu().numpy()
            for n in range(len(images)):
                jobs.append(pool.submit(
                    write_png, os.path.join(d, "image_left",
                                            f"{n:06d}_left.png"),
                    images[n], 1))
                jobs.append(pool.submit(
                    np.save, os.path.join(d, "depth_left",
                                          f"{n:06d}_left_depth.npy"),
                    depths[n]))
            poses = sc["poses"].astype(np.float64)
            poses[:, :3] *= DEPTH_SCALE
            np.savetxt(os.path.join(d, "pose_left.txt"),
                       poses[:, NED_INVERSE], delimiter=" ")
            dirs.append(d)
        for j in jobs:
            j.result()
    return dirs


def make(params, H, W, seed, device, n_frames):
    """The port's TartanAir reader over freshly written files: crops of
    (H, W), `n_frames` frames a sample."""
    from droid_slam_tpu_torch.data.tartan import TartanAir

    root = tempfile.mkdtemp(prefix="droid_bench_tartan_")
    try:
        write_scenes(os.path.join(root, "scenes"), params, seed, device)
        data = TartanAir(os.path.join(root, "scenes"), n_frames=n_frames,
                         crop_size=(H, W), fmin=params["fmin"],
                         fmax=params["fmax"],
                         cache_dir=os.path.join(root, "cache"),
                         device="cpu" if device.type == "cpu" else device)
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    weakref.finalize(data, shutil.rmtree, root, ignore_errors=True)
    return data
