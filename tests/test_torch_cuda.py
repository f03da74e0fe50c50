"""GPU-only checks: the port's CUDA kernels against their plain PyTorch
versions, and the per-frame step on the card against the CPU path.
Imports nothing of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.ops import corr as tcorr


def _mk(seed, E, HW, h2, w2):
    rng = np.random.default_rng(seed)
    vol = rng.standard_normal((E, HW, h2, w2)).astype(np.float32)
    coords = np.stack([rng.uniform(-4, w2 + 4, (E, HW)),
                       rng.uniform(-4, h2 + 4, (E, HW))], -1).astype(
        np.float32)
    return vol, coords


def _to_cuda(v):
    """A GraphState field on the card (tensors) or copied (host arrays)."""
    if torch.is_tensor(v):
        return v.cuda()
    return v.copy() if isinstance(v, np.ndarray) else v


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1, 2, 3, 4])
def test_keyframe_steps_cuda_match_cpu(seed):
    """The whole per-frame step on the card (kernel, cuDNN convolutions
    with TF32 off, index_add BA) vs the plain CPU path, each step started
    from the CPU state: same keyframe decisions, poses within 5e-4, and
    disparities within 1e-2 + 1% with their 99th percentile error under
    5e-3: f32 solves that sum in another order meet a few ill-conditioned
    pixels.  Synthetic frames (scene seed), f32 network.  Prints its
    readings.  Read on an H100 over seeds 1-4, five steps each: poses at
    most 7.9e-5, disparity error beyond 1% at most 2.7e-3, 99th
    percentile at most 1.5e-3 (all seed 1, step 8); each bound keeps at
    least 3x room over the largest reading."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses
    import os.path as osp

    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.data.synthetic import render_box_scene
    from droid_slam_tpu_torch.runtime.slam import Droid

    weights = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                       "weights", "droid_synth.npz")
    scene = render_box_scene(10, 96, 128, seed=seed, motion_scale=0.12)
    imgs, intr = scene["images"], scene["intrinsics"][0]
    cfg = SLAMConfig(image_size=(96, 128), buffer=32, warmup=5,
                     filter_thresh=0.0, compute_dtype="float32")
    cpu = Droid(cfg, weights_path=weights, device="cpu")
    gpu = Droid(cfg, weights_path=weights, device="cuda")
    for k in range(5):
        cpu.track(float(k), imgs[k], intrinsics=intr)
    assert cpu.frontend.is_initialized

    errs = []
    for k in range(5, 10):
        for f in dataclasses.fields(cpu.video.state):
            getattr(gpu.video.state, f.name).copy_(
                getattr(cpu.video.state, f.name))
        gpu.video.counter = cpu.video.counter
        g = cpu.frontend.g
        gpu.frontend.g = dataclasses.replace(
            g, **{f.name: _to_cuda(getattr(g, f.name))
                  for f in dataclasses.fields(g)})
        gpu.frontend.t1 = cpu.frontend.t1
        gpu.frontend.is_initialized = True

        cpu.track(float(k), imgs[k], intrinsics=intr)
        gpu.track(float(k), imgs[k], intrinsics=intr)
        n = cpu.video.counter
        assert gpu.video.counter == n
        dp = (gpu.video.state.poses[:n + 1].cpu()
              - cpu.video.state.poses[:n + 1]).abs()
        want = cpu.video.state.disps[:n + 1]
        dd = (gpu.video.state.disps[:n + 1].cpu() - want).abs()
        errs.append((k, float(dp.max()),
                     float((dd - 1e-2 * want.abs()).max()),
                     float(dd.flatten().quantile(0.99))))
    # (step, pose error, disparity error beyond 1%, 99th percentile of the
    # disparity error)
    print(f"seed {seed}: {errs}")
    assert all(e[1] < 5e-4 and e[2] < 1e-2 and e[3] < 5e-3
               for e in errs), errs


@pytest.mark.cuda
def test_cuda_kernel_matches_reference():
    """The CUDA kernel vs its plain version on the card, both layouts,
    f32 and bf16 volumes: identical f32 arithmetic (the kernel avoids FMA
    contraction), so atol=rtol=1e-5 is loose."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for dtype in (torch.float32, torch.bfloat16):
        vol, coords = _mk(9, 4, 300, 15, 20)
        vq = torch.from_numpy(vol).cuda().to(dtype)
        c = torch.from_numpy(coords).cuda()
        for view in (vq.permute(0, 2, 3, 1).contiguous(),
                     tcorr.query_major_view(vq)):
            got = tcorr.lookup_flat_cuda(view, c)
            want = tcorr.lookup_flat_reference(view, c)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
