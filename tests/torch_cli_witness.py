"""Both packages on the scene of `chip_smoke.py`'s cli path, on the CPU, at
the demo's default width: the witness behind ROADMAP C8 (the demo's
384x512 width never held against the reference).

    JAX_PLATFORMS=cpu python tests/torch_cli_witness.py --pkg port|jax \\
        [--frames N] > run.jsonl
    python tests/torch_cli_witness.py --compare port.jsonl jax.jsonl

Renders `render_box_scene(N, 480, 640, seed=1, motion_scale=0.12)` as the
cli path does and resizes every frame to 384x512 once, with the port's
`data/warp.resize_linear` (the demo's stream does the same resize; both
packages here get the identical uint8 frames and the intrinsics scaled
with them).  Runs `SLAMConfig(image_size=(384, 512))` with the shipped
weights through `droid_slam_tpu_torch.Droid(..., device="cpu")` (`port`)
or `droid_slam_tpu.Droid` (`jax`; `--widen` widens its one-hot lookup to
f32 as the parity tests do, which is the port's arithmetic).  At this
width every update round
correlates on the fly in blocks of 512 query pixels.  Prints one JSON line
for the keyframe timestamps and poses after the boot and after each of
the first `--steps` keyframe steps, then one with the keyframe count, the
ATE after a Sim(3) alignment and the alignment's scale.

Two more modes attribute a difference (both packages in one process):
`--pkg staged` copies the JAX Droid's state into the port's before every
stage (the boot and each keyframe step) and prints, per stage, the
largest pose difference and the Sim(3) scale between the two; `--pkg
cross` boots the JAX Droid twice, once as it runs and once on the port's
pre-boot encoder outputs (fmaps, nets, inps), and prints each boot's
Sim(3) scale against the JAX package's own and the port's.

`--compare` reads two such outputs and prints, stage by stage, whether the
keyframe timestamps agree, the largest pose difference, and the Sim(3)
alignment of the second run's keyframe centres to the first's: its
scale and the largest difference left after it (a monocular run fixes
its trajectory only up to scale).

A CPU study: at this width the JAX run takes about twenty minutes on 8
cores.  Only the tests' helpers import both packages; this script is not
collected by pytest.
"""

import argparse
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


def cli_scene(n_frames, size=(384, 512)):
    """The cli path's frames at `size` and their intrinsics."""
    from droid_slam_tpu_torch.data.synthetic import render_box_scene
    from droid_slam_tpu_torch.data.warp import resize_linear

    H, W = size
    sc = render_box_scene(n_frames, 480, 640, seed=1, motion_scale=0.12)
    imgs = [resize_linear(im, H, W) for im in sc["images"]]
    s = np.array([W / 640, H / 480, W / 640, H / 480], np.float32)
    return imgs, sc["intrinsics"][0] * s, sc["poses_c2w"]


def centres(poses_w2c):
    """Camera centres of (N, 7) world-to-camera poses [t, q]."""
    import torch

    from droid_slam_tpu_torch.lie import se3
    return se3.inv(torch.tensor(poses_w2c, dtype=torch.float64))[:, :3] \
        .numpy()


def compare(path_a, path_b):
    """Stage-by-stage agreement of two witness outputs."""
    from droid_slam_tpu_torch.geom.align import umeyama

    def stages(path):
        with open(path) as f:
            rows = [json.loads(line) for line in f if line.startswith("{")]
        return ({r["stage"]: r for r in rows if "stage" in r},
                [r for r in rows if "keyframes" in r])

    (sa, fa), (sb, fb) = stages(path_a), stages(path_b)
    for name in sa:
        if name not in sb:
            print(json.dumps(dict(stage=name, missing=path_b)))
            continue
        a, b = sa[name], sb[name]
        same_t = a["tstamps"] == b["tstamps"]
        out = dict(stage=name, frame=[a["frame"], b["frame"]],
                   keyframes=[len(a["tstamps"]), len(b["tstamps"])],
                   same_tstamps=same_t)
        if same_t:
            d = np.abs(np.asarray(a["poses"]) - np.asarray(b["poses"]))
            ca, cb = centres(a["poses"]), centres(b["poses"])
            s, R, t = umeyama(cb, ca)
            aligned = np.abs((s * (R @ cb.T)).T + t - ca)
            out.update(max_pose_diff=float(d.max()),
                       max_translation_diff=float(d[:, :3].max()),
                       per_keyframe_max=d.max(1).round(6).tolist(),
                       sim3_scale=float(s),
                       max_centre_diff_after_sim3=float(aligned.max()))
        print(json.dumps(out))
    for a, b in zip(fa, fb):
        print(json.dumps(dict(final=[{k: r[k] for k in (
            "pkg", "widen", "keyframes", "ate_sim3", "sim3_scale",
            "track_s") if k in r}
            for r in (a, b)])))


def attribute(mode, imgs, intr):
    """The `staged` and `cross` modes (see the module docstring)."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from droid_slam_tpu.config import SLAMConfig as JC
    from droid_slam_tpu.runtime.slam import Droid as JD
    from droid_slam_tpu_torch.config import SLAMConfig as TC
    from droid_slam_tpu_torch.geom.align import umeyama
    from droid_slam_tpu_torch.runtime.slam import Droid as TD
    from torch_port_common import copy_graph, copy_video

    def scale(ref, poses):
        return float(umeyama(centres(np.asarray(ref, np.float64)),
                             centres(np.asarray(poses, np.float64)))[0])

    size = dict(image_size=(384, 512))
    jd = JD(JC(**size), weights_path=WEIGHTS)
    td = TD(TC(**size), weights_path=WEIGHTS, device="cpu")
    if mode == "cross":
        jx = JD(JC(**size), weights_path=WEIGHTS)
        for k in range(len(imgs)):
            if jd.frontend.is_initialized:
                break
            if k == jd.cfg.warmup - 1:     # the boot frame: hand over
                st = jx.video.state
                jx.video.state = st.replace(**{
                    f: jnp.asarray(getattr(td.video.state, f).float()
                                   .numpy()).astype(getattr(st, f).dtype)
                    for f in ("fmaps", "nets", "inps")})
            for d in (jd, jx, td):
                d.track(float(k), imgs[k], intrinsics=intr)
            jd._sync()
            jx._sync()
        n = jd.video.counter
        ref = np.array(jd.video.state.poses[:n])
        print(json.dumps(dict(
            mode=mode, boot_frame=k - 1, keyframes=n,
            jax_on_port_encoders_scale=scale(
                ref, np.array(jx.video.state.poses[:n])),
            port_scale=scale(ref, td.video.state.poses[:n].numpy()))),
            flush=True)
        return
    for k, im in enumerate(imgs):
        if jd.frontend.is_initialized:
            copy_video(jd, td)
            copy_graph(jd, td)
        elif k == jd.cfg.warmup - 1:
            copy_video(jd, td)
        jd.track(float(k), im, intrinsics=intr)
        jd._sync()
        td.track(float(k), im, intrinsics=intr)
        n = jd.video.counter
        if not jd.frontend.is_initialized:
            continue
        pj = np.array(jd.video.state.poses[:n])
        pt = td.video.state.poses[:td.video.counter].numpy()
        out = dict(mode=mode, frame=k, keyframes=[n, td.video.counter])
        if pt.shape == pj.shape:
            out.update(same_tstamps=bool(np.array_equal(
                np.array(jd.video.state.tstamp[:n]),
                td.video.state.tstamp[:n].numpy())),
                max_pose_diff=float(np.abs(pj - pt).max()),
                sim3_scale=scale(pj, pt))
        print(json.dumps(out), flush=True)


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--pkg", choices=("port", "jax", "staged", "cross"))
    p.add_argument("--widen", action="store_true",
                   help="JAX: widen the one-hot lookup to f32")
    p.add_argument("--frames", type=int, default=36)
    p.add_argument("--steps", type=int, default=5,
                   help="keyframe steps whose poses are printed")
    p.add_argument("--compare", nargs=2, metavar=("A", "B"))
    args = p.parse_args()
    if args.compare:
        compare(*args.compare)
        return
    if args.pkg is None:
        p.error("--pkg or --compare is required")

    t = time.time()
    imgs, intr, poses_c2w = cli_scene(args.frames)
    print(json.dumps(dict(render_s=time.time() - t)), flush=True)

    if args.pkg in ("staged", "cross"):
        attribute(args.pkg, imgs, intr)
        return
    if args.pkg == "port":
        from droid_slam_tpu_torch.config import SLAMConfig
        from droid_slam_tpu_torch.runtime.slam import Droid
        d = Droid(SLAMConfig(image_size=(384, 512)), weights_path=WEIGHTS,
                  device="cpu")
    else:
        import jax
        jax.config.update("jax_platforms", "cpu")
        from droid_slam_tpu.config import SLAMConfig
        from droid_slam_tpu.runtime.slam import Droid
        if args.widen:
            import pytest
            from torch_port_common import widen_onehot
            widen_onehot(pytest.MonkeyPatch())
        d = Droid(SLAMConfig(image_size=(384, 512)), weights_path=WEIGHTS)

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
                                  poses=kf[1], s=time.time() - t)),
                  flush=True)
        elif booted and printed < args.steps and kf != last:
            printed += 1
            print(json.dumps(dict(stage=f"step {printed}", frame=k,
                                  tstamps=kf[0], poses=kf[1],
                                  s=time.time() - t)), flush=True)
        last = kf
    t_track = time.time() - t
    n_kf = d.video.counter
    t = time.time()
    traj = np.asarray(d.terminate((float(k), im, intr)
                                  for k, im in enumerate(imgs)))
    from droid_slam_tpu_torch.geom.align import ate_rmse, umeyama
    gt = poses_c2w[:, :3]
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    print(json.dumps(dict(
        pkg=args.pkg, widen=args.widen, size=[384, 512],
        frames=args.frames, keyframes=n_kf,
        ate_sim3=ate_rmse(gt, traj[:, :3]),
        sim3_scale=umeyama(traj[:, :3], gt)[0], path_length=path,
        track_s=t_track, terminate_s=time.time() - t)), flush=True)


if __name__ == "__main__":
    main()
