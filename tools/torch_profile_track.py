"""Where the PyTorch port's tracking time goes on a CUDA card.

    python tools/torch_profile_track.py

Runs `droid_slam_tpu_torch.Droid(SLAMConfig())` with the shipped weights on
the synthetic textured-box sequence of chip_smoke.py (240x320, seed 1,
motion_scale 0.12, 80 frames).  The first 40 frames are tracked
unprofiled (warmup boot, first keyframe steps); the rest are tracked under
torch.profiler.  Prints one JSON line:

  * window_ms: host time of the profiled window (ends in a synchronize);
  * device_busy_ms: union of the intervals in which a kernel or copy ran;
  * device_idle_share: 1 - busy / (first device start .. last device end);
  * launches: device events in the window, and per keyframe;
  * top: device time by kernel name, the 15 largest, with its share of
    the busy time and its launch count;
  * lookup: device time, share of the busy time and launch count of each
    of the package's own lookup kernels that ran.

The profiler's own overhead stretches the host side, so window_ms and the
idle share are upper bounds of the unprofiled run's.  Needs a CUDA card.
"""

import json
import os
import sys
import time
from collections import defaultdict

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FRAMES = 80     # the sequence of chip_smoke.py
SKIP = 40       # frames tracked before the profiled window
TOP = 15        # kernels listed
# the package's own kernels (csrc/), by the name of their entry point
LOOKUP_KERNELS = ("corr_lookup", "lookup_level_fwd", "lookup_level_v2_fwd",
                  "lookup_level_bwd")


def union_ms(intervals):
    """Total length (ms) of the union of (start_us, end_us) intervals."""
    total, end = 0.0, None
    for a, b in sorted(intervals):
        if end is None or a > end:
            total += b - a
            end = b
        elif b > end:
            total += b - end
            end = b
    return total / 1e3


def device_summary(prof):
    """Device-side totals of a finished torch.profiler run: busy time
    (union of kernel and copy intervals), span, idle share, launch count,
    the TOP kernels by device time and the package's own lookup kernels."""
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = [(e.time_range.start, e.time_range.end) for e in dev]
    busy = union_ms(spans)
    span = ((max(b for _, b in spans) - min(a for a, _ in spans)) / 1e3
            if spans else 0.0)
    by_name = defaultdict(lambda: [0.0, 0])
    for e in dev:
        by_name[e.name][0] += (e.time_range.end - e.time_range.start) / 1e3
        by_name[e.name][1] += 1
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:TOP]
    lookup = {}
    for k in LOOKUP_KERNELS:
        own = [v for n, v in by_name.items() if k + "_kernel" in n]
        if own:
            ms = sum(v[0] for v in own)
            lookup[k] = dict(ms=ms, share=ms / busy if busy else 0,
                             count=sum(v[1] for v in own))
    return dict(
        lookup=lookup,
        device_busy_ms=busy, device_span_ms=span,
        device_idle_share=(1.0 - busy / span) if span > 0 else None,
        launches=len(dev),
        top=[dict(name=n[:120], ms=v[0], share=v[0] / busy if busy else 0,
                  count=v[1]) for n, v in top])


def main():
    if not torch.cuda.is_available():
        print("torch_profile_track: no CUDA device", file=sys.stderr)
        return 1

    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.data.synthetic import render_box_scene
    from droid_slam_tpu_torch.runtime.slam import Droid

    cfg = SLAMConfig()
    H, W = cfg.image_size
    scene = render_box_scene(FRAMES, H, W, seed=1, motion_scale=0.12)
    images, intr = scene["images"], scene["intrinsics"][0]
    droid = Droid(cfg, weights_path=os.path.join(ROOT, "weights",
                                                 "droid_synth.npz"))
    for k in range(SKIP):
        droid.track(float(k), images[k], intrinsics=intr)
    torch.cuda.synchronize()
    kf0 = droid.video.counter

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t = time.time()
        passed = sum(bool(droid.track(float(k), images[k], intrinsics=intr))
                     for k in range(SKIP, FRAMES))
        torch.cuda.synchronize()
        window_ms = (time.time() - t) * 1e3

    summary = device_summary(prof)
    n_kf = droid.video.counter - kf0
    out = dict(
        device=torch.cuda.get_device_name(0),
        frames=FRAMES - SKIP, filter_passed=passed,
        keyframes_added=n_kf, window_ms=window_ms,
        launches_per_passed_frame=summary["launches"] / max(passed, 1),
        **summary)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
