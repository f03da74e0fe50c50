"""Both packages on the stereo scene of `chip_smoke.py`'s stereo phase, on
the CPU, at the EuRoC preset's full width: the witness behind ROADMAP C6
(stereo losing metric scale at 320x512 on some scenes).

    JAX_PLATFORMS=cpu python tests/torch_stereo_witness.py --pkg port|jax

Renders `render_stereo_box_scene(60, 320, 512, seed=2, motion_scale=0.12)`
once and runs `PRESETS["euroc"]` with `stereo=True` and the shipped
weights through `droid_slam_tpu_torch.Droid(..., device="cpu")` (`port`)
or `droid_slam_tpu.Droid` (`jax`; `--widen` widens its one-hot lookup to
f32 as the parity tests do, which is the port's arithmetic).  Prints one
JSON line for the poses of every keyframe after the boot and after each of
the first `--steps` keyframe steps, then one with the keyframe count, the
ATE after a Sim(3) alignment and the alignment's scale.

A CPU study: at this width a JAX run takes tens of minutes on 8 cores.
`--frames` and `--size` cut it for a quick look.  Only the tests' helpers
import both packages; this script is not collected by pytest.
"""

import argparse
import dataclasses
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "weights", "droid_synth.npz")


def keyframes(d):
    """(timestamps, poses) of the keyframes, as copies."""
    n = d.video.counter
    st = d.video.state
    return (np.array(st.tstamp[:n]).tolist(),
            np.array(st.poses[:n]).astype(np.float64).round(6).tolist())


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--pkg", choices=("port", "jax"), required=True)
    p.add_argument("--widen", action="store_true",
                   help="JAX: widen the one-hot lookup to f32")
    p.add_argument("--frames", type=int, default=60)
    p.add_argument("--size", type=int, nargs=2, default=(320, 512))
    p.add_argument("--seed", type=int, default=2)
    p.add_argument("--steps", type=int, default=5,
                   help="keyframe steps whose poses are printed")
    args = p.parse_args()

    from droid_slam_tpu_torch.data.synthetic import render_stereo_box_scene
    from droid_slam_tpu_torch.geom.align import ate_rmse, umeyama

    H, W = args.size
    t = time.time()
    sc = render_stereo_box_scene(args.frames, H, W, seed=args.seed,
                                 motion_scale=0.12)
    imgs, intr = list(sc["images"]), sc["intrinsics"][0]
    print(json.dumps(dict(render_s=time.time() - t)), flush=True)

    if args.pkg == "port":
        from droid_slam_tpu_torch.config import PRESETS
        from droid_slam_tpu_torch.runtime.slam import Droid
        cfg = dataclasses.replace(PRESETS["euroc"], stereo=True,
                                  image_size=(H, W))
        d = Droid(cfg, weights_path=WEIGHTS, device="cpu")
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        from droid_slam_tpu.config import PRESETS
        from droid_slam_tpu.runtime.slam import Droid
        if args.widen:
            import pytest
            from torch_port_common import widen_onehot
            widen_onehot(pytest.MonkeyPatch())
        cfg = dataclasses.replace(PRESETS["euroc"], stereo=True,
                                  image_size=(H, W))
        d = Droid(cfg, weights_path=WEIGHTS)

    def sync():
        if args.pkg == "jax":
            d._sync()

    t = time.time()
    booted, printed, last = False, 0, None
    for k, im in enumerate(imgs):
        d.track(float(k), im, intrinsics=intr)
        sync()
        kf = keyframes(d)
        if d.frontend.is_initialized and not booted:
            booted = True
            print(json.dumps(dict(stage="boot", frame=k, tstamps=kf[0],
                                  poses=kf[1])), flush=True)
        elif booted and printed < args.steps and kf != last:
            printed += 1
            print(json.dumps(dict(stage=f"step {printed}", frame=k,
                                  tstamps=kf[0], poses=kf[1])), flush=True)
        last = kf
    t_track = time.time() - t
    n_kf = d.video.counter
    t = time.time()
    traj = d.terminate((float(k), im[0], intr) for k, im in enumerate(imgs))
    gt = sc["poses_c2w"][:, :3]
    s = umeyama(np.asarray(traj)[:, :3], gt)[0]
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    print(json.dumps(dict(
        pkg=args.pkg, widen=args.widen, size=[H, W], seed=args.seed,
        frames=args.frames, keyframes=n_kf,
        ate_sim3=ate_rmse(gt, np.asarray(traj)[:, :3]), sim3_scale=s,
        path_length=path, track_s=t_track, terminate_s=time.time() - t)),
        flush=True)


if __name__ == "__main__":
    main()
