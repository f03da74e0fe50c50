"""Run visual SLAM on an image stream with the PyTorch/CUDA port.

Loads a calibration file, streams images from a directory (undistorting
and resizing them as needed) or a dataset, tracks every frame, optionally
writes the filtered keyframe point cloud, and writes the final camera
trajectory (one `t x y z qx qy qz qw` line per frame).  PNG is read
without OpenCV; JPEG needs OpenCV or PIL.

Examples:
  python -m droid_slam_tpu_torch.demo --imagedir data/images \\
      --calib calib/tum3.txt --weights weights/droid_synth.npz
  python -m droid_slam_tpu_torch.demo --synthetic 30 --device cpu

Runs on the CUDA card unless --device names another torch device.  The
last line of its output is a JSON summary of the run: frames, keyframes,
seconds spent reading the stream (decode, undistort, resize), tracking
and terminating, and on the card the lookup-kernel launches and peak
device memory.
"""

import argparse
import dataclasses
import json
import sys
import time

import numpy as np


def synthetic_stream(n, H=64, W=96, seed=0):
    """n frames of a moving sinusoidal texture with noise, (t, image,
    intrinsics)."""
    rng = np.random.default_rng(seed)
    intr = np.asarray([0.8 * W, 0.8 * W, W / 2, H / 2], np.float32)
    y, x = np.mgrid[0:H, 0:W].astype(np.float32)
    for t in range(n):
        img = (
            127 + 60 * np.sin(0.2 * (x + 3 * t)) * np.cos(0.15 * (y + 2 * t))
            + 40 * np.sin(0.05 * (x - y + 5 * t))
        )
        img = np.clip(img + rng.normal(0, 2, (H, W)), 0, 255).astype(np.uint8)
        yield t, np.stack([img] * 3, -1), intr


def as_frame(tup):
    """Any stream's tuple -> (t, image, depth or None, intrinsics): the
    intrinsics are the (4,) array, a depth map the 2-D one; a right image
    (KITTI stereo) and timestamps are dropped."""
    t, image, *rest = tup
    intr = next(a for a in rest if np.ndim(a) == 1 and len(a) == 4)
    depth = next((a for a in rest if np.ndim(a) == 2), None)
    return t, image, depth, intr


def build_parser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--imagedir", help="directory of input images")
    p.add_argument("--calib", help="calibration file (fx fy cx cy [dist])")
    p.add_argument("--datapath", default=None,
                   help="dataset directory; layout auto-detected "
                        "(ETH3D/TartanAir/TUM/EuRoC/KITTI, "
                        "data/factory.py:create_stream)")
    p.add_argument("--weights", default=None,
                   help="network weights: an .npz, or the reference's "
                        "droid.pth; seeded random weights without it")
    p.add_argument("--synthetic", type=int, default=0,
                   help="run on N synthetic frames instead of images")
    p.add_argument("--preset", default="demo",
                   choices=["demo", "tum", "euroc", "eth3d", "tartanair"])
    p.add_argument("--buffer", type=int, default=None)
    p.add_argument("--stride", type=int, default=1)
    p.add_argument("--t0", type=int, default=0)
    p.add_argument("--filter_thresh", type=float, default=None)
    p.add_argument("--warmup", type=int, default=None)
    p.add_argument("--backend_steps", type=int, nargs=2, default=(7, 12))
    p.add_argument("--target_area", type=int, default=384 * 512,
                   help="resize input so H*W is about this")
    p.add_argument("--output", default="trajectory.txt",
                   help="output trajectory file (t x y z qx qy qz qw)")
    p.add_argument("--export_ply", default=None,
                   help="write the filtered keyframe point cloud here")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    return p


def main(argv=None):
    p = build_parser()
    args = p.parse_args(argv)
    if not args.synthetic and not args.datapath \
            and not (args.imagedir and args.calib):
        p.error("provide --imagedir and --calib, --datapath, "
                "or --synthetic N")

    import torch

    from .config import PRESETS
    from .data import streams
    from .data.factory import create_stream
    from .ops import corr
    from .runtime.slam import Droid, resolve_device

    device = resolve_device(args.device)
    t = time.time()
    if args.synthetic:
        frames = [(t_, im, None, intr)
                  for t_, im, intr in synthetic_stream(args.synthetic)]
    elif args.datapath:
        frames = [as_frame(tup) for tup in
                  create_stream(args.datapath, stride=args.stride)]
    else:
        frames = [(t_, im, None, intr) for t_, im, intr in
                  streams.directory_stream(args.imagedir, args.calib,
                                           args.stride, args.target_area,
                                           t0=args.t0)]
    stream_s = time.time() - t
    if not frames:
        print("no input frames found", file=sys.stderr)
        return 1

    H, W = frames[0][1].shape[:2]
    overrides = {"image_size": (H, W)}
    for k in ("buffer", "filter_thresh", "warmup"):
        if getattr(args, k) is not None:
            overrides[k] = getattr(args, k)
    if args.synthetic:
        overrides.update(
            buffer=max(32, args.synthetic), warmup=5, filter_thresh=0.0,
            frontend_window=10, frontend_pose_cap=32, frontend_depth_cap=32,
        )
    cfg = dataclasses.replace(PRESETS[args.preset], **overrides)
    droid = Droid(cfg, weights_path=args.weights, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t = time.time()
    for t_, image, depth, intr in frames:
        droid.track(t_, image, depth=depth, intrinsics=intr)
        print(f"\rframe {t_}  keyframes={droid.video.counter}",
              end="", flush=True)
    print()
    sync()
    track_s = time.time() - t
    keyframes = droid.video.counter

    n_pts = None
    if args.export_ply:
        from .runtime.visualization import export_point_cloud
        n_pts = export_point_cloud(droid.video, args.export_ply)
        print(f"wrote {n_pts} points to {args.export_ply}")

    t = time.time()
    traj = droid.terminate(((f[0], f[1], f[3]) for f in frames),
                           backend_steps=tuple(args.backend_steps))
    sync()
    terminate_s = time.time() - t

    ts = np.asarray([f[0] for f in frames], np.float64)
    out = np.column_stack([ts, traj[:, :3], traj[:, 3:]])
    np.savetxt(args.output, out, fmt="%.6f")
    print(f"wrote {len(out)} poses to {args.output}")

    summary = dict(device=str(device), frames=len(frames),
                   image_size=[H, W], keyframes=keyframes,
                   stream_s=stream_s, track_s=track_s,
                   terminate_s=terminate_s, ply_points=n_pts)
    if device.type == "cuda":
        summary.update(launches=corr.launch_counts(),
                       peak_mem_bytes=torch.cuda.max_memory_allocated(device))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
