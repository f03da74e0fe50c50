"""Helpers shared by the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py)."""

import dataclasses
import glob
import os
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


def write_dataset(root, protocol, n=8, H=96, W=128):
    """A tiny dataset in `protocol`'s layout from the port's box scene
    (PNG through the port's encoder) under the pathlib directory `root`;
    returns the port's extra CLI arguments for it."""
    from droid_slam_tpu_torch.data.image_io import write_png
    from droid_slam_tpu_torch.data.synthetic import render_box_scene

    sc = render_box_scene(n, H, W, seed=6, motion_scale=0.12)
    ts = 100.0 + 0.05 * np.arange(n)
    gt = np.column_stack([ts, sc["poses_c2w"]])
    if protocol == "eth3d":
        (root / "rgb").mkdir()
        (root / "depth").mkdir()
        with open(root / "rgb.txt", "w") as fr, \
                open(root / "depth.txt", "w") as fd:
            for k, t in enumerate(ts):
                write_png(str(root / f"rgb/{t:.6f}.png"), sc["images"][k])
                write_png(str(root / f"depth/{t:.6f}.png"),
                          (sc["depths"][k] * 5000).astype(np.uint16))
                fr.write(f"{t:.6f} rgb/{t:.6f}.png\n")
                fd.write(f"{t:.6f} depth/{t:.6f}.png\n")
        np.savetxt(root / "calibration.txt", sc["intrinsics"][0])
        np.savetxt(root / "groundtruth.txt", gt)
        return ["--stride", "1"]
    if protocol == "euroc":
        for cam in ("cam0", "cam1"):
            d = root / "mav0" / cam / "data"
            d.mkdir(parents=True)
            for k, t in enumerate(ts):
                write_png(str(d / f"{int(t * 1e9)}.png"), sc["images"][k])
        np.savetxt(root / "gt.txt", gt, delimiter=" ")
        return ["--gt", str(root / "gt.txt"), "--stereo", "--stride", "1",
                "--image_size", str(H), str(W)]
    (root / "image_left").mkdir()
    for k in range(n):
        write_png(str(root / f"image_left/{k:06d}.png"), sc["images"][k])
    ned = sc["poses_c2w"][:, [2, 0, 1, 5, 3, 4, 6]]   # inverse permutation
    np.savetxt(root / "pose_left.txt", ned, delimiter=" ")
    return ["--image_size", str(H), str(W)]


# --- the evaluation CLIs of both packages (ROADMAP C9) ----------------------

TUM = osp.join(ROOT, "tests", "fixtures", "tum_tiny")
# the dry-run overrides both sides run with
EVAL_OVERRIDES = dict(buffer=32, warmup=5, filter_thresh=0.0)
EVAL_SIZE = (96, 128)


class _Recorder:
    """What an evaluation protocol hands its Droid: the configuration, the
    tracked frames, the fill stream and the trajectory it got back."""

    def __init__(self):
        self.cfg, self.track, self.fill, self.traj = None, [], [], None

    def droid_class(self, base, replay=None):
        """A subclass of `base` (a package's Droid) that records; with
        `replay` ((n, 7) c2w poses) it computes nothing and `terminate`
        returns the first poses of `replay`, one per fill frame."""
        rec = self

        class Recorded(base):
            def __init__(self, cfg, **kw):
                rec.cfg = dataclasses.asdict(cfg)
                if replay is None:
                    super().__init__(cfg, **kw)

            def track(self, t, image, depth=None, intrinsics=None):
                rec.track.append((float(t), np.array(image),
                                  None if depth is None else np.array(depth),
                                  np.array(intrinsics, np.float64)))
                if replay is None:
                    return super().track(t, image, depth=depth,
                                         intrinsics=intrinsics)
                return True

            def terminate(self, stream=None, backend_steps=(7, 12)):
                frames = list(stream)
                rec.fill = [(float(f[0]), np.array(f[2], np.float64))
                            for f in frames]
                if replay is None:
                    traj = super().terminate(iter(frames), backend_steps)
                else:
                    traj = replay[: len(frames)]
                rec.traj = np.array(traj, np.float64)
                return traj

        return Recorded

    def state(self):
        return dict(cfg=self.cfg, track=self.track, fill=self.fill,
                    traj=self.traj)


def reference_eval_main(spec_path):
    """Run one of the reference's evaluation scripts as `__main__` would,
    on the CPU, with the dry-run overrides it has no flag for applied to
    its preset (and, for EuRoC and TartanAir, to its stream's resize), its
    Droid recorded (or replayed), and the record pickled.  The subprocess
    entry of `run_reference_eval`."""
    import json
    import pickle
    import runpy
    import sys

    import jax
    jax.config.update("jax_platforms", "cpu")

    from droid_slam_tpu import config
    from droid_slam_tpu.data import streams
    from droid_slam_tpu.runtime import slam

    with open(spec_path) as f:
        spec = json.load(f)
    over = dict(spec["overrides"])
    if "image_size" in over:
        over["image_size"] = tuple(over["image_size"])
    preset = spec["preset"]
    config.PRESETS[preset] = dataclasses.replace(config.PRESETS[preset],
                                                 **over)
    replay = None if spec["replay"] is None else np.load(spec["replay"])
    rec = _Recorder()
    slam.Droid = rec.droid_class(slam.Droid, replay)
    g = runpy.run_path(spec["script"], run_name="reference_eval")
    size = spec.get("stream_size")
    if size and preset == "euroc":
        streams.euroc_stream.__defaults__ = (False, 1, tuple(size))
    if size and preset == "tartanair":
        g["tartan_stream"].__defaults__ = (1, tuple(size))
    sys.argv = [spec["script"], *spec["argv"]]
    g["main"]()
    with open(spec["record"], "wb") as f:
        pickle.dump(rec.state(), f)


def run_reference_eval(tmp, script, argv, preset, overrides, replay=None,
                       stream_size=None, timeout=900):
    """`evaluation_scripts/<script>` with `argv` in a subprocess on the
    CPU (see `reference_eval_main`); returns (stdout lines, record)."""
    import json
    import pickle
    import subprocess
    import sys

    tag = f"{script}_{'replay' if replay is not None else 'live'}"
    spec = dict(script=osp.join(ROOT, "evaluation_scripts", script),
                argv=list(argv), preset=preset, overrides=overrides,
                stream_size=stream_size, record=str(tmp / f"{tag}.pkl"),
                replay=None)
    if replay is not None:
        spec["replay"] = str(tmp / f"{tag}_traj.npy")
        np.save(spec["replay"], replay)
    spec_path = tmp / f"{tag}.json"
    spec_path.write_text(json.dumps(spec))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]; "
            "from torch_port_common import reference_eval_main; "
            "reference_eval_main(sys.argv[3])")
    res = subprocess.run([sys.executable, "-c", code, ROOT,
                          osp.join(ROOT, "tests"), str(spec_path)],
                         capture_output=True, text=True, timeout=timeout,
                         env=env, cwd=str(tmp))
    assert res.returncode == 0, res.stdout[-3000:] + res.stderr[-3000:]
    with open(spec["record"], "rb") as f:
        return res.stdout.strip().splitlines(), pickle.load(f)


def run_port_eval(argv, replay=None):
    """`droid_slam_tpu_torch.evaluate.main(argv)` in this process with its
    Droid recorded (or replayed); returns (stdout lines, record)."""
    import contextlib
    import io

    from droid_slam_tpu_torch import evaluate
    from droid_slam_tpu_torch.runtime import slam

    rec = _Recorder()
    base = slam.Droid
    slam.Droid = rec.droid_class(base, replay)
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            evaluate.main(list(argv))
    finally:
        slam.Droid = base
    return out.getvalue().strip().splitlines(), rec.state()


def eval_protocols(tmp):
    """Every protocol's data (TUM: tests/fixtures/tum_tiny; EuRoC, ETH3D
    and TartanAir written by `write_dataset` under `tmp`) and both sides'
    arguments with the same overrides: {name: (reference script,
    reference argv, preset, overrides the script takes no flag for,
    stream resize or None, port argv)}."""
    common = ["--weights", WEIGHTS, "--backend_steps", "2", "2"]
    port_over = ["--buffer", "32", "--warmup", "5", "--filter_thresh", "0",
                 "--device", "cpu"]
    size = [str(s) for s in EVAL_SIZE]
    out = {"tum": (
        "test_tum.py",
        ["--datapath", TUM, "--stride", "1", "--image_size", *size,
         "--buffer", "32", "--warmup", "5", "--filter_thresh", "0",
         *common], "tum", {}, None,
        ["tum", "--datapath", TUM, "--stride", "1", "--image_size", *size,
         *port_over, *common])}
    no_flag = dict(warmup=5, filter_thresh=0.0)
    for name in ("euroc", "eth3d", "tartanair"):
        root = tmp / name
        root.mkdir()
        extra = write_dataset(root, name)
        if name == "euroc":
            for mode, stereo in (("euroc_stereo", ["--stereo"]),
                                 ("euroc_mono", [])):
                out[mode] = (
                    "test_euroc.py",
                    ["--datapath", str(root), "--gt", str(root / "gt.txt"),
                     *stereo, "--stride", "1", "--buffer", "32", *common],
                    "euroc", dict(no_flag, image_size=EVAL_SIZE), EVAL_SIZE,
                    ["euroc", "--datapath", str(root), "--gt",
                     str(root / "gt.txt"), *stereo, "--stride", "1",
                     "--image_size", *size, *port_over, *common])
        elif name == "eth3d":
            out[name] = (
                "test_eth3d.py",
                ["--datapath", str(root), "--stride", "1", "--buffer", "32",
                 *common], "eth3d", no_flag, None,
                ["eth3d", "--datapath", str(root), *extra, *port_over,
                 *common])
        else:
            out[name] = (
                "validate_tartanair.py",
                ["--datapath", str(root), "--stride", "1", *common],
                "tartanair", dict(EVAL_OVERRIDES, image_size=EVAL_SIZE),
                EVAL_SIZE,
                ["tartanair", "--datapath", str(root), "--stride", "1",
                 *extra, *port_over, *common])
    return out


# C1's live bound on keyframe poses: two packages' live runs of the same
# frames agree this far (tests/torch_live_sensitivity.py)
LIVE_POSE_TOL = 0.05


def check_live_eval(tmp, mode):
    """Both evaluation CLIs of `mode` on the same data with the same
    overrides, each tracking for real: the same poses are scored, the
    trajectories agree within LIVE_POSE_TOL per pose component, and so do
    the printed errors.  Returns both packages' printed lines."""
    import re

    script, ref_argv, preset, over, size, port_argv = eval_protocols(tmp)[
        mode]
    ref_lines, ref = run_reference_eval(tmp, script, ref_argv, preset, over,
                                        stream_size=size)
    port_lines, port = run_port_eval(port_argv)
    assert port["traj"].shape == ref["traj"].shape
    np.testing.assert_allclose(port["traj"], ref["traj"], rtol=0,
                               atol=LIVE_POSE_TOL)

    def numbers(lines):
        got = [ln for ln in lines if "=" in ln]
        return ([float(x) for x in re.findall(r"= \(?(-?[\d.]+|nan)", ln)]
                for ln in got), [re.sub(r"[-\d.]+|nan", "#", ln)
                                 for ln in got]

    (nr, fr), (np_, fp) = numbers(ref_lines), numbers(port_lines)
    assert fp == fr and fr, (port_lines, ref_lines)
    for a, b in zip(np_, nr):
        np.testing.assert_allclose(a, b, rtol=0, atol=LIVE_POSE_TOL)
    return ref_lines, port_lines
