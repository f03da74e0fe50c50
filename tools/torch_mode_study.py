"""Accuracy of the PyTorch port's `Droid` across input modes on the same
synthetic scenes, on a CUDA card.

    python tools/torch_mode_study.py [--size 320 512]

For each of the scene seeds 2, 3 and 4, renders 60 frames of the stereo
box scene of chip_smoke.py's stereo phase (motion_scale 0.12, right
camera 0.1 along the left one's x axis) at `--size` (the preset's
320x512 by default) and runs
`PRESETS["euroc"]` at that size with the shipped weights three ways on
it: stereo pairs (`stereo=True`), the left images alone (mono),
and the left images with their exact depths (RGB-D).  Each run tracks
every frame and terminates (global BA + fill).  Prints one JSON line per
run: keyframes, ATE RMSE after a Sim(3) alignment (chip_smoke.py's), the
alignment's scale and the path length.  Scale is observable with stereo
and depth, not mono.  Needs a CUDA card.
"""

import argparse
import dataclasses
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# scene seeds (2 is chip_smoke.py's stereo scene) and frames per scene
SEEDS = (2, 3, 4)
FRAMES = 60


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, nargs=2, default=[320, 512])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_mode_study: no CUDA device", file=sys.stderr)
        return 1
    from chip_smoke import umeyama_ate
    from droid_slam_tpu_torch.config import PRESETS
    from droid_slam_tpu_torch.data.synthetic import render_stereo_box_scene
    from droid_slam_tpu_torch.runtime.slam import Droid

    H, W = args.size
    base = dataclasses.replace(PRESETS["euroc"], image_size=(H, W))
    for seed in SEEDS:
        sc = render_stereo_box_scene(FRAMES, H, W, seed=seed,
                                     motion_scale=0.12)
        intr = sc["intrinsics"][0]
        gt = sc["poses_c2w"][:, :3]
        path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
        for mode in ("stereo", "mono", "rgbd"):
            cfg = dataclasses.replace(base, stereo=mode == "stereo")
            images = sc["images"] if mode == "stereo" else sc["images"][:, 0]
            droid = Droid(cfg, weights_path=os.path.join(
                ROOT, "weights", "droid_synth.npz"))
            for k in range(FRAMES):
                droid.track(float(k), images[k],
                            depth=sc["depths"][k] if mode == "rgbd" else None,
                            intrinsics=intr)
            n_kf = droid.video.counter
            traj = droid.terminate(
                ((float(k), images[k], intr) for k in range(FRAMES)))
            ate, scale = umeyama_ate(traj[:, :3], gt)
            print(json.dumps(dict(seed=seed, size=[H, W], mode=mode,
                                  keyframes=n_kf,
                                  ate_sim3=ate, sim3_scale=scale,
                                  path_length=path)), flush=True)
            del droid
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
