"""Helpers shared by the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py)."""

import glob
import os.path as osp

import jax.numpy as jnp
import numpy as np
import torch

from droid_slam_tpu.ops import corr as jcorr

ROOT = osp.dirname(osp.dirname(osp.abspath(__file__)))
FIX = osp.join(ROOT, "tests", "fixtures", "tiny_seq")
WEIGHTS = osp.join(ROOT, "weights", "droid_synth.npz")

# tiny_seq end to end: 96x128, f32 network, warmup 5, every frame passes
# the motion filter, room for the filler's batch of 16 beside 6 keyframes
TINY = dict(image_size=(96, 128), buffer=32, warmup=5, filter_thresh=0.0,
            compute_dtype="float32")


def widen_onehot(monkeypatch):
    """The JAX one-hot lookup rounds its weights and row sums to the
    volume's bf16; the TPU kernel (and the port) widen the volume to f32
    first.  Patch it to do the same; call before a JAX Droid is built,
    since its jit traces capture the function."""
    orig = jcorr.lookup_level_onehot_flat

    def widened(vol, coords, radius=jcorr.RADIUS):
        return orig(vol.astype(jnp.float32), coords, radius)

    monkeypatch.setattr(jcorr, "lookup_level_onehot_flat", widened)


def tiny_seq():
    """tests/fixtures/tiny_seq: 12 RGB uint8 frames and (fx, fy, cx, cy)."""
    import cv2

    imgs = [cv2.cvtColor(cv2.imread(p), cv2.COLOR_BGR2RGB)
            for p in sorted(glob.glob(osp.join(FIX, "*.png")))]
    intr = np.loadtxt(osp.join(FIX, "calib.txt")).astype(np.float32)[:4]
    return imgs, intr


# stereo and RGB-D: 10 frames of the port's textured box at 96x128, as
# tiny_seq's configuration, with a filler batch of 10 (one fill batch).
# Stereo runs without the volume cache, so its keyframe steps correlate on
# the fly, as the EuRoC preset's 320x512 frames do (their volumes exceed
# the cache budget); RGB-D keeps the cache, as at the ETH3D preset's size.
BOX_FRAMES = 10
MODES = {
    "stereo": dict(TINY, stereo=True, filler_batch=BOX_FRAMES,
                   corr_cache_mb=0),
    "rgbd": dict(TINY, upsample=True, filler_batch=BOX_FRAMES),
}


def box_seq(mode):
    """The box scene of `mode` rendered by the port (numpy, so both
    packages get the same inputs): (images, depths or None, intrinsics).
    Stereo images are (2, H, W, 3) [left, right]; RGB-D frames come with
    their exact depth maps."""
    from droid_slam_tpu_torch.data import synthetic

    if mode == "stereo":
        sc = synthetic.render_stereo_box_scene(BOX_FRAMES, 96, 128, seed=4,
                                               motion_scale=0.12)
        return list(sc["images"]), None, sc["intrinsics"][0]
    sc = synthetic.render_box_scene(BOX_FRAMES, 96, 128, seed=4,
                                    motion_scale=0.12)
    return list(sc["images"]), list(sc["depths"]), sc["intrinsics"][0]


# keyframe buffers both packages hold, in the same shapes
FIELDS = ("tstamp", "poses", "disps", "disps_sens", "disps_up",
          "intrinsics", "fmaps", "nets", "inps", "damping")


def copy_video(jd, td):
    """The JAX Droid's keyframe buffers and counter into the port's."""
    js, ts = jd.video.state, td.video.state
    for f in FIELDS:
        a = getattr(js, f)
        if f in ("fmaps", "nets", "inps"):
            a = a.astype(jnp.float32)
        getattr(ts, f).copy_(torch.from_numpy(np.array(a)))
    td.video.counter = jd.video.counter


def copy_graph(jd, td):
    """The JAX fused frontend's graph state into the port's."""
    jg, tg = jd.frontend.gstate, td.frontend.g
    for f in ("ii", "jj", "age", "seq", "active", "inac"):
        setattr(tg, f, np.array(getattr(jg, f)).astype(getattr(tg, f).dtype))
    tg.ring_ptr, tg.tick = int(jg.ring_ptr), int(jg.tick)
    for f in ("target", "weight", "net"):
        getattr(tg, f).copy_(torch.from_numpy(np.array(getattr(jg, f))))
    td.frontend.t1 = jd.frontend.t1


def run_staged_and_live(mode):
    """Both packages on `box_seq(mode)` with the shipped weights.

    One JAX Droid runs live.  One port Droid tracks the warmup frames on
    its own (the live and the staged run are the same until the frontend
    initializes); after the boot it forks into a live run and a staged
    one.  Before each later stage of the JAX Droid (every fused keyframe
    step, each of two global-BA passes of 2 sweeps, the fill) its state is
    copied into the staged port Droid, which then runs the same stage.
    The staged fill runs in one batch and in batches of 4 against the JAX
    package's one batch (each frame's fill is its own problem, so the
    batching does not change it).  Returns the readings the tests
    compare, as numpy."""
    import copy

    from droid_slam_tpu.config import SLAMConfig as JC
    from droid_slam_tpu.lie import se3 as jse3
    from droid_slam_tpu.runtime.slam import Droid as JD
    from droid_slam_tpu_torch.config import SLAMConfig as TC
    from droid_slam_tpu_torch.runtime.slam import Droid as TD

    cfg = MODES[mode]
    imgs, depths, intr = box_seq(mode)
    depths = depths or [None] * len(imgs)
    jd = JD(JC(**cfg), weights_path=WEIGHTS)
    staged = TD(TC(**cfg), weights_path=WEIGHTS, device="cpu")
    live = None

    def video(d):
        n = d.video.counter
        st = d.video.state
        out = {f: np.array(getattr(st, f)[:n + 1]).astype(np.float32)
               for f in ("tstamp", "poses", "disps", "disps_sens",
                         "disps_up")}
        out["counter"] = n
        return out

    rec = dict(steps=[], ba=[])
    for k, (im, dep) in enumerate(zip(imgs, depths)):
        if live is not None:
            copy_video(jd, staged)
            copy_graph(jd, staged)
        jd.track(float(k), im, depth=dep, intrinsics=intr)
        jd._sync()
        staged.track(float(k), im, depth=dep, intrinsics=intr)
        if live is not None:
            live.track(float(k), im, depth=dep, intrinsics=intr)
        edges = [tuple(np.asarray(e)) for e in (jd.frontend.active_edges(),
                                                staged.frontend.active_edges())]
        stage = dict(jax=video(jd), port=video(staged), edges=edges)
        if k == cfg["warmup"] - 1:
            assert jd.frontend.is_initialized
            jg, tg = jd.frontend.gstate, staged.frontend.g
            stage["graph"] = {f: (np.asarray(getattr(jg, f)),
                                  getattr(tg, f))
                              for f in ("ii", "jj", "age", "seq", "active",
                                        "inac")}
            rec["boot"] = stage
            live = copy.deepcopy(staged)
        elif k >= cfg["warmup"]:
            rec["steps"].append(stage)

    n = live.video.counter
    rec["live_keyframes"] = (np.array(live.video.state.tstamp[:n]),
                             np.array(live.video.state.poses[:n]))
    n = jd.video.counter
    rec["jax_keyframes"] = (np.array(jd.video.state.tstamp[:n]),
                            np.array(jd.video.state.poses[:n]))

    def stream():
        return ((float(k), im, intr) for k, im in enumerate(imgs))

    for steps in (2, 2):                     # global BA passes
        copy_video(jd, staged)
        jd.backend(steps)
        staged.backend(steps)
        rec["ba"].append(dict(jax=video(jd), port=video(staged)))
    copy_video(jd, staged)
    want = jd.traj_filler(stream())
    rec["fill"] = (want, staged.traj_filler(stream()))
    # in batches of 4 as well: three batches reuse the same buffer slots,
    # one after the other
    copy_video(jd, staged)
    staged.traj_filler.batch = 4
    rec["fill_batched"] = (want, staged.traj_filler(stream()))
    rec["live_traj"] = (np.asarray(jse3.inv(jnp.asarray(want))),
                        live.terminate(stream(), backend_steps=(2, 2)))
    return rec
