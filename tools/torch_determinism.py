"""Does the port's mono path repeat on the card, and if not, which op makes
the difference?  (ROADMAP C7.)

    python tools/torch_determinism.py [--frames 80]

Needs a CUDA card.  `CUBLAS_WORKSPACE_CONFIG=:4096:8` is set before CUDA
starts.  First a check of the suspects alone: `index_add_` over a
collision-heavy index, twice on the same inputs, against
`index_put_(accumulate=True)` and against `index_add_` under
`torch.use_deterministic_algorithms(True)`.  Then
`Droid(SLAMConfig())` with the shipped weights tracks the box scene of
`chip_smoke.py`'s main path (seed 1, motion_scale 0.12, 240x320) and
terminates, twice in each mode:

    default         as the port runs
    deterministic   torch.use_deterministic_algorithms(True)
    cudnn           torch.backends.cudnn.deterministic = True only
    index_put       every dim-0 `index_add_` as `index_put_(accumulate=True)`

Under `deterministic` an op without a deterministic implementation
warns instead of raising; the line lists those warnings.  Prints one JSON
line per mode: whether the two runs' keyframe poses agree
after every frame (the first frame where they differ, and the largest
difference while the keyframe counts agree), the keyframe counts, the
largest difference of the final trajectories, and frames/s of each run.
"""

import argparse
import json
import os
import sys
import time
import warnings

os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

WEIGHTS = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "weights", "droid_synth.npz")


def suspects():
    """Each candidate op twice on the same collision-heavy inputs: are the
    two results bit-equal?"""
    g = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, 64, (200000,), device="cuda", generator=g)
    src = torch.randn((200000, 36), device="cuda", generator=g)

    def twice(fn):
        a, b = fn(), fn()
        return bool(torch.equal(a, b)), float((a - b).abs().max())

    def add():
        return torch.zeros((64, 36), device="cuda").index_add_(0, idx, src)

    def put():
        return torch.zeros((64, 36), device="cuda").index_put_(
            (idx,), src, accumulate=True)

    out = dict(index_add=twice(add), index_put_accumulate=twice(put))
    torch.use_deterministic_algorithms(True)
    try:
        out["index_add_deterministic"] = twice(add)
    finally:
        torch.use_deterministic_algorithms(False)
    return out


def run_mono(scene, mode):
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.runtime.slam import Droid

    images, intr = scene["images"], scene["intrinsics"][0]
    droid = Droid(SLAMConfig(), weights_path=WEIGHTS)
    snaps = []
    torch.cuda.synchronize()
    t0 = time.time()
    for k, im in enumerate(images):
        droid.track(float(k), im, intrinsics=intr)
        n = droid.video.counter
        snaps.append(droid.video.state.poses[:n].double().cpu().numpy())
    torch.cuda.synchronize()
    fps = len(images) / (time.time() - t0)
    traj = droid.terminate((float(k), im, intr)
                           for k, im in enumerate(images))
    return snaps, traj, fps


def compare(a, b):
    (sa, ta, fa), (sb, tb, fb) = a, b
    first, worst = None, 0.0
    for k, (x, y) in enumerate(zip(sa, sb)):
        if x.shape != y.shape:
            first = k if first is None else first
            break
        d = float(np.abs(x - y).max()) if x.size else 0.0
        if d > 0 and first is None:
            first = k
        worst = max(worst, d)
    return dict(bit_equal=first is None and bool(np.array_equal(ta, tb)),
                first_frame_differing=first,
                max_pose_diff_while_counts_agree=worst,
                keyframes=[len(sa[-1]), len(sb[-1])],
                max_traj_diff=float(np.abs(ta - tb).max())
                if ta.shape == tb.shape else None,
                fps=[fa, fb])


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--frames", type=int, default=80)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    from droid_slam_tpu_torch.data.synthetic import render_box_scene

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(json.dumps(dict(suspects=suspects())), flush=True)
    scene = render_box_scene(args.frames, 240, 320, seed=1,
                             motion_scale=0.12)

    orig = torch.Tensor.index_add_

    def index_put_add(self, dim, index, source, alpha=1):
        if dim != 0 or alpha != 1:
            return orig(self, dim, index, source, alpha=alpha)
        return self.index_put_((index,), source, accumulate=True)

    for mode in ("default", "deterministic", "cudnn", "index_put"):
        torch.use_deterministic_algorithms(mode == "deterministic",
                                           warn_only=True)
        torch.backends.cudnn.deterministic = mode == "cudnn"
        if mode == "index_put":
            torch.Tensor.index_add_ = index_put_add
        try:
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                runs = [run_mono(scene, mode) for _ in range(2)]
        finally:
            torch.Tensor.index_add_ = orig
            torch.use_deterministic_algorithms(False)
            torch.backends.cudnn.deterministic = False
        nondet = sorted({str(w.message).split("\n")[0][:160]
                         for w in caught if "determinis" in str(w.message)})
        print(json.dumps(dict(mode=mode, **compare(*runs),
                              nondeterministic_ops=nondet)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
