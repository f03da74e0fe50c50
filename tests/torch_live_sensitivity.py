"""How far the live trajectory of each package moves under f32-sized
changes: the study behind the live bounds of tests/test_torch_slam.py
(mono), tests/test_torch_stereo.py and tests/test_torch_rgbd.py.

    JAX_PLATFORMS=cpu python tests/torch_live_sensitivity.py [--mode M]

A CPU study (both packages run on the CPU; the port on one thread, as in
the tests, where its result does not depend on the thread count).  Runs
`droid_slam_tpu_torch.Droid` and `droid_slam_tpu.Droid` with the shipped
weights, the JAX one-hot lookup widened to f32, track, then
terminate(stream, backend_steps=(2, 2)), on the input of `--mode`:
  mono    tests/fixtures/tiny_seq with the configuration of
          tests/test_torch_slam.py (96x128, f32 network, warmup 5,
          filter_thresh 0, buffer 32);
  stereo  the stereo box scene of tests/torch_port_common.box_seq with
          its configuration `MODES["stereo"]`;
  rgbd    the box scene with its depths, `MODES["rgbd"]` (upsample on).
Each package runs several times:

  * as it is (its baseline);
  * with the intrinsics scaled by 1 + eps, eps in EPS (one f32 rounding
    step of the intrinsics is ~6e-8 relative);
  * with every dense-BA call run in float64 (inputs widened, outputs
    rounded back to float32).

Prints one JSON line per run: the keyframe timestamps, and the largest
absolute difference from the package's own baseline of the keyframe poses
after tracking and of each filled frame.  A last line compares the two
baselines.  Changes this small that move a package's trajectory far mean
the live loop amplifies rounding, so two correct f32 implementations that
round differently cannot agree tighter than that spread end to end.
"""

import argparse
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
from torch_port_common import (MODES, TINY, WEIGHTS, box_seq,  # noqa
                               tiny_seq, widen_onehot)

EPS = (1e-7, -1e-7, 1e-6, -1e-6)
THREADS = 1


def run(pkg, cfg, imgs, depths, intr):
    """One live run; returns (keyframe timestamps, keyframe poses after
    tracking, (n, 7) filled trajectory)."""
    if pkg == "port":
        from droid_slam_tpu_torch.config import SLAMConfig
        from droid_slam_tpu_torch.runtime.slam import Droid
        d = Droid(SLAMConfig(**cfg), weights_path=WEIGHTS, device="cpu")
    else:
        from droid_slam_tpu.config import SLAMConfig
        from droid_slam_tpu.runtime.slam import Droid
        d = Droid(SLAMConfig(**cfg), weights_path=WEIGHTS)
    for k, (im, dep) in enumerate(zip(imgs, depths)):
        d.track(float(k), im, depth=dep, intrinsics=intr)
    if pkg == "jax":
        d._sync()
    n = d.video.counter
    st = d.video.state
    # copies: terminate updates the port's buffers in place
    ts = np.array(st.tstamp[:n])
    kp = np.array(st.poses[:n])
    traj = d.terminate(((float(k), im, intr) for k, im in enumerate(imgs)),
                       backend_steps=(2, 2))
    return ts, kp, traj


def port_ba_float64(orig):
    def ba(*args, **kw):
        args = [a.double() if torch.is_tensor(a) and a.is_floating_point()
                else a for a in args]
        old = torch.get_default_dtype()
        torch.set_default_dtype(torch.float64)
        try:
            poses, disps = orig(*args, **kw)
        finally:
            torch.set_default_dtype(old)
        return poses.float(), disps.float()
    return ba


def jax_ba_float64(orig):
    def wide(a):
        if hasattr(a, "dtype") and jnp.issubdtype(a.dtype, jnp.floating):
            return a.astype(jnp.float64)
        return a

    def ba(*args, **kw):
        # float64 inside this call only (the rest of the traced step stays
        # float32 / int32)
        with jax.enable_x64(True):
            poses, disps = orig(*[wide(a) for a in args],
                                **{k: wide(v) for k, v in kw.items()})
            return poses.astype(jnp.float32), disps.astype(jnp.float32)
    return ba


def report(pkg, variant, base, got):
    (bts, bkp, btraj), (ts, kp, traj) = base, got
    same = kp.shape == bkp.shape
    print(json.dumps(dict(
        package=pkg, variant=variant, keyframes=ts.tolist(),
        kp_max_abs=float(np.abs(kp - bkp).max()) if same else None,
        fill_max_abs_per_frame=[round(float(e), 4) for e in
                                np.abs(traj - btraj).max(1)],
    )), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("mono", "stereo", "rgbd"),
                    default="mono")
    mode = ap.parse_args().mode
    torch.set_num_threads(THREADS)
    if mode == "mono":
        cfg, (imgs, intr), depths = TINY, tiny_seq(), None
    else:
        cfg = MODES[mode]
        imgs, depths, intr = box_seq(mode)
    depths = depths or [None] * len(imgs)
    mp = pytest.MonkeyPatch()
    widen_onehot(mp)
    base = {}
    for pkg in ("port", "jax"):
        base[pkg] = run(pkg, cfg, imgs, depths, intr)
        report(pkg, "baseline", base[pkg], base[pkg])
        for eps in EPS:
            got = run(pkg, cfg, imgs, depths,
                      (intr * (1.0 + eps)).astype(np.float32))
            report(pkg, f"intrinsics x (1 + {eps:g})", base[pkg], got)

    from droid_slam_tpu_torch.ops import dba as tdba
    mp.setattr(tdba, "ba", port_ba_float64(tdba.ba))
    report("port", "dense BA in float64", base["port"],
           run("port", cfg, imgs, depths, intr))

    from droid_slam_tpu.ops import dba as jdba
    mp.setattr(jdba, "ba", jax_ba_float64(jdba.ba))
    report("jax", "dense BA in float64", base["jax"],
           run("jax", cfg, imgs, depths, intr))
    mp.undo()

    report("port", "vs the JAX baseline", base["jax"], base["port"])


if __name__ == "__main__":
    main()
