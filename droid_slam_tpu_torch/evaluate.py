"""Evaluate the PyTorch/CUDA port on the reference benchmarks.

    python -m droid_slam_tpu_torch.evaluate tum --datapath SEQ
    python -m droid_slam_tpu_torch.evaluate euroc --datapath SEQ --gt GT \\
        [--stereo]
    python -m droid_slam_tpu_torch.evaluate eth3d --datapath SEQ
    python -m droid_slam_tpu_torch.evaluate tartanair --datapath SCENE
    python -m droid_slam_tpu_torch.evaluate synthetic [--weights W | --ckpt C]

The protocols of the JAX package's `evaluation_scripts/` (test_tum.py,
test_euroc.py, test_eth3d.py, validate_tartanair.py):

  tum        stride-2 tracking of undistorted 240x320 frames, full
             terminate, Sim(3)-aligned ATE against groundtruth.txt
  euroc      rectified frames at 320x512, stride 2; positions scaled by
             1.10 before alignment; ATE with (mono) or without (stereo)
             scale correction, stereo also printing the Sim(3) diagnostic
  eth3d      associated RGB-D pairs (depth / 5000) with the depth prior;
             SE(3)-aligned (metric) ATE
  tartanair  384x512 frames, Sim(3)-aligned ATE, translational RPE and
             the KITTI segment-drift pair on the aligned estimate

and the dataset-free accuracy harness of `eval_synthetic.py`:

  synthetic  rendered box (or plane) scenes with exact ground truth, seeds
             apart from the training curriculum's; Sim(3)-aligned ATE per
             scene, then the median and the mean over the finite ones;
             `--compare` also runs the seeded initialisation on the same
             scenes and prints the ratio

`--image_size`, `--buffer`, `--warmup` and `--filter_thresh` override the
protocol for short dry runs.  `--weights` takes an .npz or the reference's
droid.pth; `synthetic` also takes `--ckpt`, a checkpoint that training
wrote.  Runs on the CUDA card unless --device names another torch
device.
"""

import argparse
import dataclasses
import glob
import os.path as osp
import sys

import numpy as np

from .data.tartan import NED_PERMUTATION, TartanAir


def _overrides(args):
    over = {k: getattr(args, k) for k in ("buffer", "warmup",
                                          "filter_thresh")
            if getattr(args, k, None) is not None}
    if getattr(args, "image_size", None) is not None:
        over["image_size"] = tuple(args.image_size)
    return over


def _droid(args, preset, **over):
    from .config import PRESETS
    from .runtime.slam import Droid

    cfg = dataclasses.replace(PRESETS[preset], **{**_overrides(args),
                                                   **over})
    return Droid(cfg, weights_path=args.weights, device=args.device)


def _resized(frames, size):
    """(t, image, intr) frames resized to size = (H, W), intrinsics
    scaled with them."""
    from .data.warp import resize_linear

    H, W = size
    out = []
    for t, im, intr in frames:
        s = np.array([W / im.shape[1], H / im.shape[0]] * 2, np.float32)
        out.append((t, resize_linear(im, H, W), intr * s))
    return out


def eval_tum(args):
    from .data.streams import tum_stream
    from .geom.align import associate, ate_rmse

    droid = _droid(args, "tum")
    frames = list(tum_stream(args.datapath, stride=args.stride))
    if args.image_size is not None:
        frames = _resized(frames, args.image_size)
    for (t, image, intr) in frames:
        droid.track(t, image, intrinsics=intr)
    traj = droid.terminate(iter(frames),
                           backend_steps=tuple(args.backend_steps))

    gt = np.loadtxt(osp.join(args.datapath, "groundtruth.txt"))
    rgb_files = sorted(
        glob.glob(osp.join(args.datapath, "rgb", "*.png")))[::args.stride]
    tstamps = [float(osp.basename(f)[:-4]) for f in rgb_files]
    matches = associate(tstamps, gt[:, 0], max_dt=0.08)
    est = np.asarray([traj[i, :3] for i, _ in matches])
    ref = np.asarray([gt[j, 1:4] for _, j in matches])
    ate = ate_rmse(ref, est, correct_scale=True)
    print(f"TUM {osp.basename(osp.normpath(args.datapath))}: "
          f"ATE RMSE (Sim3-aligned) = {ate:.4f} m over {len(matches)} "
          f"poses")
    return ate


def eval_euroc(args):
    from .data.streams import euroc_stream
    from .geom.align import associate, ate_rmse

    size = tuple(args.image_size) if args.image_size else (320, 512)
    droid = _droid(args, "euroc", stereo=args.stereo, image_size=size)
    frames = list(euroc_stream(args.datapath, stereo=args.stereo,
                               stride=args.stride, image_size=size))
    for (t, image, intr, _) in frames:
        droid.track(t, image, intrinsics=intr)
    fill = ((t, im if not args.stereo else im[0], intr)
            for (t, im, intr, _) in frames)
    traj = droid.terminate(fill, backend_steps=tuple(args.backend_steps))

    # the reference scales positions by 1.10 before the alignment
    positions = 1.10 * traj[:, :3]
    tstamps = np.asarray([ts for (_, _, _, ts) in frames]) / 1e9
    gt = np.loadtxt(args.gt, delimiter=" ")
    matches = associate(tstamps, gt[:, 0], max_dt=0.05)
    est = np.asarray([positions[i] for i, _ in matches])
    ref = np.asarray([gt[j, 1:4] for _, j in matches])
    ate = ate_rmse(ref, est, correct_scale=not args.stereo)
    mode = "stereo" if args.stereo else "mono"
    print(f"EuRoC {osp.basename(osp.normpath(args.datapath))} ({mode}): "
          f"ATE RMSE = {ate:.4f} m over {len(matches)} poses")
    if args.stereo:
        # if the Sim(3)-corrected ATE is much smaller, the SE(3) error is
        # the stereo unit's scale, not tracking
        ate_s = ate_rmse(ref, est, correct_scale=True)
        n_e = np.linalg.norm(est - est.mean(0), axis=1)
        n_r = np.linalg.norm(ref - ref.mean(0), axis=1)
        s = float((n_e * n_r).sum() / max((n_e ** 2).sum(), 1e-12))
        print(f"  [diag] Sim3-corrected ATE = {ate_s:.4f} m; "
              f"best-fit scale ref/est = {s:.4f}")
    return ate


def eval_eth3d(args):
    from .data.streams import eth3d_stream
    from .geom.align import associate, ate_rmse

    frames = list(eth3d_stream(args.datapath, stride=args.stride))
    H, W = frames[0][1].shape[:2]
    droid = _droid(args, "eth3d", image_size=(H, W))
    for (t, image, depth, intr, _) in frames:
        droid.track(t, image, depth=depth, intrinsics=intr)
    fill = ((t, im, intr) for (t, im, _, intr, _) in frames)
    traj = droid.terminate(fill, backend_steps=tuple(args.backend_steps))

    tstamps = [ts for (_, _, _, _, ts) in frames]
    gt_path = osp.join(args.datapath, "groundtruth.txt")
    if not osp.isfile(gt_path):
        np.savetxt(args.output, np.column_stack([tstamps, traj]))
        print(f"no groundtruth.txt; wrote {args.output}")
        return None
    gt = np.loadtxt(gt_path)
    matches = associate(tstamps, gt[:, 0], max_dt=0.05)
    est = np.asarray([traj[i, :3] for i, _ in matches])
    ref = np.asarray([gt[j, 1:4] for _, j in matches])
    # RGB-D is metric: no scale correction
    ate = ate_rmse(ref, est, correct_scale=False)
    print(f"ETH3D {osp.basename(osp.normpath(args.datapath))}: "
          f"ATE RMSE (SE3-aligned) = {ate:.4f} m over {len(matches)} poses")
    return ate


def tartan_frames(scene_dir, stride=1, image_size=(384, 512)):
    """`image_left/*.png` resized to image_size, at the TartanAir
    calibration scaled with it."""
    from .data.image_io import imread_rgb
    from .data.warp import resize_linear

    H, W = image_size
    intr0 = TartanAir.calib_read()
    images = sorted(glob.glob(osp.join(scene_dir, "image_left/*.png")))
    for t, path in enumerate(images[::stride]):
        img = imread_rgb(path)
        h0, w0 = img.shape[:2]
        intr = intr0 * np.array([W / w0, H / h0, W / w0, H / h0])
        yield t, resize_linear(img, H, W), intr.astype(np.float32)


def eval_tartanair(args):
    from .geom.align import ate_rmse, kitti_metric, rpe

    size = tuple(args.image_size) if args.image_size else (384, 512)
    droid = _droid(args, "tartanair", image_size=size)
    frames = list(tartan_frames(args.datapath, args.stride, size))
    for (t, image, intr) in frames:
        droid.track(t, image, intrinsics=intr)
    traj = droid.terminate(iter(frames),
                           backend_steps=tuple(args.backend_steps))

    gt = np.loadtxt(osp.join(args.datapath, "pose_left.txt"), delimiter=" ")
    gt = gt[::args.stride][: len(traj), NED_PERMUTATION]
    ate = ate_rmse(gt[:, :3], traj[:, :3], correct_scale=True)
    r = rpe(gt[:, :3], traj[:, :3])
    k_rot, k_tra = kitti_metric(gt[:, :7], traj[:, :7], align=True,
                                correct_scale=True)
    print(f"TartanAir {osp.basename(osp.normpath(args.datapath))}: "
          f"ATE = {ate:.4f}  RPE(t) = {r:.4f}  "
          f"KITTI = ({k_rot:.4f} deg/m, {k_tra:.4f} m/m) "
          f"over {len(traj)} poses")
    return ate


def eval_synthetic(args):
    from .config import SLAMConfig
    from .data.synthetic import render_box_scene, render_plane_scene
    from .geom.align import ate_rmse
    from .runtime.slam import Droid, resolve_device

    H, W = args.size
    device = resolve_device(args.device)
    ckpt = None
    if args.ckpt:
        import torch

        ckpt = torch.load(args.ckpt, map_location="cpu", weights_only=True)
        print(f"loaded checkpoint at step {ckpt['step']}")

    def run_scene(seed, learned, tag=""):
        render = (render_box_scene if args.scene == "box"
                  else render_plane_scene)
        scene = render(args.n_frames, H, W, seed=seed,
                       motion_scale=args.motion)
        cfg = SLAMConfig(
            image_size=(H, W), compute_dtype=args.dtype,
            buffer=args.n_frames + 20,   # keyframes + filler batch
            filler_batch=8, warmup=6, filter_thresh=0.0,
            keyframe_thresh=0.01, frontend_window=10, frontend_pose_cap=32,
            frontend_depth_cap=32, frontend_thresh=64.0,
            backend_thresh=args.backend_thresh,
            backend_nms=args.backend_nms,
        )
        droid = Droid(cfg, weights_path=args.weights if learned else None,
                      device=device, seed=0)
        if learned and ckpt is not None:
            droid.net.load_state_dict(ckpt["model"], strict=True)

        intr = scene["intrinsics"][0]
        for t in range(args.n_frames):
            droid.track(t, scene["images"][t], intrinsics=intr)
        n_kf = droid.video.counter
        traj = droid.terminate(
            ((t, scene["images"][t], intr) for t in range(args.n_frames)),
            backend_steps=tuple(args.backend_steps))

        gt = scene["poses_c2w"]
        ate = ate_rmse(gt[:, :3], traj[:, :3], correct_scale=True)
        span = np.linalg.norm(gt[:, :3] - gt[:1, :3], axis=1).max()
        print(f"seed {seed}{tag}: ATE = {ate:.4f} m (trajectory span "
              f"{span:.3f} m, {n_kf} keyframes)")
        return ate

    def agg(vals, name):
        """The median over the finite runs (the headline) and their mean,
        with the count of diverged (non-finite) runs."""
        v = np.asarray(vals, np.float64)
        fin = v[np.isfinite(v)]
        n_div = int(np.sum(~np.isfinite(v)))
        mean = float(fin.mean()) if len(fin) else float("inf")
        med = float(np.median(fin)) if len(fin) else float("inf")
        print(f"{name}: median {med:.4f} m, mean(finite) {mean:.4f} m"
              + (f", {n_div} diverged" if n_div else ""))
        return med

    learned = args.weights is not None or ckpt is not None
    results = [run_scene(s, learned) for s in args.seeds]
    med_l = agg(results, f"learned ATE over {len(results)} scenes")
    if args.compare:
        base = [run_scene(s, False, tag=" [random-init]")
                for s in args.seeds]
        med_r = agg(base, "random-init ATE")
        print(f"learned/random median ratio {med_l / med_r:.3f} "
              f"(improvement {med_r / med_l:.2f}x)")
    return med_l


def build_parser():
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--datapath", required=True)
    common.add_argument("--weights", default=None,
                        help="network weights: an .npz, or the "
                             "reference's droid.pth; seeded random "
                             "weights without it")
    common.add_argument("--device", default=None,
                        help="torch device (default: the CUDA card)")
    common.add_argument("--buffer", type=int, default=None,
                        help="keyframe buffer override")
    common.add_argument("--warmup", type=int, default=None)
    common.add_argument("--filter_thresh", type=float, default=None)

    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    sub = p.add_subparsers(dest="benchmark", required=True)
    for name, stride, steps in (("tum", 2, (7, 12)), ("euroc", 2, (7, 12)),
                                ("eth3d", 1, (7, 12)),
                                ("tartanair", 1, (5, 10))):
        s = sub.add_parser(name, parents=[common])
        s.add_argument("--stride", type=int, default=stride)
        s.add_argument("--backend_steps", type=int, nargs=2, default=steps)
        if name != "eth3d":
            s.add_argument("--image_size", type=int, nargs=2, default=None,
                           metavar=("H", "W"))
    sub.choices["euroc"].add_argument(
        "--gt", required=True, help="groundtruth txt (t x y z ...)")
    sub.choices["euroc"].add_argument("--stereo", action="store_true")
    sub.choices["eth3d"].add_argument(
        "--output", default="eth3d_trajectory.txt",
        help="trajectory file written when there is no groundtruth.txt")

    s = sub.add_parser("synthetic")
    s.add_argument("--weights", default=None,
                   help="network weights: an .npz, or the reference's "
                        "droid.pth")
    s.add_argument("--ckpt", default=None,
                   help="a training checkpoint (step_*.pt) to score")
    s.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    s.add_argument("--n_frames", type=int, default=16)
    s.add_argument("--size", type=int, nargs=2, default=(64, 96),
                   metavar=("H", "W"))
    s.add_argument("--seeds", type=int, nargs="+", default=[11, 12])
    s.add_argument("--motion", type=float, default=0.08)
    s.add_argument("--scene", default="box", choices=["box", "plane"],
                   help="held-out scene family (seeds disjoint from the "
                        "training curriculum's)")
    s.add_argument("--backend_steps", type=int, nargs=2, default=(3, 3))
    s.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"],
                   help="network compute dtype")
    s.add_argument("--backend_thresh", type=float, default=64.0,
                   help="backend proximity threshold (small synthetic "
                        "scenes need a looser graph than the 240x320 "
                        "default)")
    s.add_argument("--backend_nms", type=int, default=1)
    s.add_argument("--compare", action="store_true",
                   help="also run the seeded initialisation on the same "
                        "scenes and print the learned/random ATE ratio")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    run = dict(tum=eval_tum, euroc=eval_euroc, eth3d=eval_eth3d,
               tartanair=eval_tartanair,
               synthetic=eval_synthetic)[args.benchmark]
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
