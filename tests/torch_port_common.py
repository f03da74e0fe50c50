"""Helpers shared by the tests that hold the PyTorch port against the JAX
package (tests/test_torch_*.py)."""

import glob
import os.path as osp

import jax.numpy as jnp
import numpy as np

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
