"""Stereo tracking cells: `Droid.track` with `stereo=True` fed rectified
pairs (2, H, W, 3) in a closed loop.

The timed path is track.py's `run`, unchanged: set-up, the window, and
the reservoir samples of rounds, gates and keyframes.  This runner keeps
a hold of the program's keyframe store while `run` frees the rest, so
that the sampled keyframes' features are checked on both cameras, and
checks with track.py's check over the plain stereo reference
(benchmark/reference/tracking_stereo.py) in place of the monocular one:
the same six numbers, the encoder's over both cameras' features.
"""

import numpy as np
import torch

from benchmark.reference import tracking_stereo
from benchmark.runners import track
from benchmark.runners.common import free


def run(ctx):
    from droid_slam_tpu_torch.runtime import slam

    kept = []
    base = slam.Droid

    class Kept(base):
        """`Droid`, its keyframe store kept once `track.run` lets go."""

        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            kept.append(self.video)

    slam.Droid = Kept
    try:
        rec = track.run(ctx)
    finally:
        slam.Droid = base
    video = kept.pop()
    st = video.state
    enc = rec["encoded"]
    have = st.tstamp[:rec["keyframes"]].cpu().numpy()
    slots = [int(np.nonzero(have == s)[0][0]) for s in enc["tstamp"]]
    enc["fmaps"] = st.fmaps[torch.as_tensor(slots, device=st.fmaps.device)
                            ].clone()
    del video, st
    free(ctx.device)
    return rec


def check(ctx, rec):
    """track.py's compared numbers with the stereo reference."""
    mono = track.ref
    track.ref = tracking_stereo
    try:
        return track.check(ctx, rec)
    finally:
        track.ref = mono
