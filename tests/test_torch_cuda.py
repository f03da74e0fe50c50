"""GPU-only checks: the port's CUDA kernels against their plain PyTorch
versions, and the per-frame step and one training accumulate step on the
card against the CPU path.
Imports nothing of JAX, so it also runs on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py

Without a card every test skips.
"""

import numpy as np
import pytest
import torch

from droid_slam_tpu_torch.ops import corr as tcorr


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


# (E, Q, planes per edge, h2, w2, levels): the serving shapes (bf16 planes
# of 30x40 halved three times, odd sizes 7x10 and 3x5), one level, query
# counts that do not fill the four queries a warp serves, and edges that
# hold more planes than they have queries
FLAT_CASES = [(64, 1200, 1200, 30, 40, 4), (3, 301, 301, 15, 20, 1),
              (2, 37, 40, 7, 10, 2), (1, 5, 5, 3, 5, 1),
              (5, 63, 64, 30, 40, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", FLAT_CASES)
def test_cuda_kernel_matches_reference(case):
    """The serving pyramid kernel vs its plain version on the card, f32
    and bf16 volumes, border windows and far-out queries: identical f32
    arithmetic in the same order (the kernel avoids FMA contraction), so
    the taps are equal bit for bit; one launch per pyramid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    E, Q, Qv, h2, w2, levels = case
    rng = np.random.default_rng(sum(case))
    coords = np.stack([rng.uniform(-5, w2 + 5, (E, Q)),
                       rng.uniform(-5, h2 + 5, (E, Q))], -1)
    coords[rng.random((E, Q)) < 0.05] = -1e4
    c = torch.from_numpy(coords.astype(np.float32)).cuda()
    for dtype in (torch.float32, torch.bfloat16):
        vols = [torch.from_numpy(rng.standard_normal(
            (E, Qv, h2 >> l, w2 >> l)).astype(np.float32)).cuda().to(dtype)
            for l in range(levels)]
        tcorr.reset_launch_counts()
        got = tcorr.lookup_pyramid_flat(vols, c)
        assert tcorr.launch_counts()["corr_lookup"] == 1
        want = tcorr.lookup_pyramid_flat_reference(vols, c)
        torch.cuda.synchronize()
        assert got.shape == (E, Q, 49 * levels)
        assert torch.equal(got, want), float((got - want).abs().max())


def _mk_level(seed, shape, oob=0.05, dtype=torch.float32):
    """A 6-D level, coordinates around the identity grid with a few
    queries far out of bounds, and tap gradients, on the card."""
    rng = np.random.default_rng(seed)
    B, N, H, W, h2, w2 = shape
    vol = rng.standard_normal(shape).astype(np.float32)
    coords = np.stack([rng.uniform(-5, w2 + 5, shape[:4]),
                       rng.uniform(-5, h2 + 5, shape[:4])], -1)
    coords[rng.random(shape[:4]) < oob] = -1e4
    g = rng.standard_normal(shape[:4] + (49,)).astype(np.float32)
    return (torch.from_numpy(vol).cuda().to(dtype),
            torch.from_numpy(coords.astype(np.float32)).cuda(),
            torch.from_numpy(g).cuda())


LEVEL_SHAPES = [(1, 3, 6, 8, 10, 12), (2, 5, 12, 16, 6, 8),
                (1, 1, 3, 3, 1, 1), (1, 7, 5, 7, 3, 5)]


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["level", "level_v2"])
def test_level_forward_kernels_match_reference(name):
    """Each level-lookup kernel vs its plain version on the card, f32 and
    bf16 volumes, query counts that do not fill a warp or a block: the
    kernel runs the plain version's f32 operations in its order without
    FMA contraction, so atol=rtol=1e-5 is loose."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    kern, ref = {
        "level": (tcorr.lookup_level_cuda, tcorr.lookup_level_reference),
        "level_v2": (tcorr.lookup_level_v2_cuda,
                     tcorr.lookup_level_v2_reference)}[name]
    for seed, shape in enumerate(LEVEL_SHAPES):
        for dtype in (torch.float32, torch.bfloat16):
            vol, coords, _ = _mk_level(seed, shape, dtype=dtype)
            got = kern(vol, coords)
            want = ref(vol, coords)
            torch.cuda.synchronize()
            torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)


# (leading shape, h2, w2, levels): the training shapes (f32 planes of 48x64
# halved three times), one level, odd plane sizes, query counts that do
# not fill the four queries a warp serves
LEVEL_PYRAMIDS = [((1, 40, 48, 64), 48, 64, 4), ((1, 3, 3, 5), 7, 10, 2),
                  ((2, 1, 1, 3), 3, 5, 1), ((1, 1, 5, 7), 15, 20, 3)]


def _mk_level_pyramid(seed, lead, h2, w2, levels, dtype=torch.float32):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pyr = [torch.randn(lead + (h2 >> l, w2 >> l), device="cuda",
                       generator=gen).to(dtype) for l in range(levels)]
    rng = np.random.default_rng(seed)
    coords = np.stack([rng.uniform(-5, w2 + 5, lead),
                       rng.uniform(-5, h2 + 5, lead)], -1)
    coords[rng.random(lead) < 0.05] = -1e4
    return pyr, torch.from_numpy(coords.astype(np.float32)).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("case", LEVEL_PYRAMIDS)
def test_level_pyramid_kernel_matches_reference(case):
    """The training pyramid kernel vs its plain version on the card, f32
    and bf16 pyramids: the plain version's f32 operations in its order
    without FMA contraction, so the taps are equal bit for bit; one launch
    per pyramid."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    lead, h2, w2, levels = case
    for dtype in (torch.float32, torch.bfloat16):
        pyr, coords = _mk_level_pyramid(levels, lead, h2, w2, levels, dtype)
        tcorr.reset_launch_counts()
        got = tcorr.lookup_pyramid(pyr, coords, impl="level")
        assert tcorr.launch_counts()["lookup_level_fwd"] == 1
        want = tcorr.lookup_pyramid_level_reference(pyr, coords)
        torch.cuda.synchronize()
        assert got.shape == lead + (49 * levels,)
        assert torch.equal(got, want), float((got - want).abs().max())


@pytest.mark.cuda
@pytest.mark.parametrize("case", LEVEL_PYRAMIDS)
def test_level_v2_pyramid_kernel_matches_reference(case):
    """The separable training pyramid kernel (the schedule of the
    four-corner one) vs its plain version on the card, f32 and bf16
    pyramids: bit for bit, one launch per pyramid, and its one-level form
    equals level 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    lead, h2, w2, levels = case
    for dtype in (torch.float32, torch.bfloat16):
        pyr, coords = _mk_level_pyramid(levels + 11, lead, h2, w2, levels,
                                        dtype)
        tcorr.reset_launch_counts()
        got = tcorr.lookup_pyramid(pyr, coords, impl="level_v2")
        assert tcorr.launch_counts()["lookup_level_v2_fwd"] == 1
        want = tcorr.lookup_pyramid_level_v2_reference(pyr, coords)
        one = tcorr.lookup_level_v2_cuda(pyr[0], coords)
        torch.cuda.synchronize()
        assert got.shape == lead + (49 * levels,)
        assert torch.equal(got, want), float((got - want).abs().max())
        assert torch.equal(one, got[..., :49])


@pytest.mark.cuda
@pytest.mark.parametrize("case", LEVEL_PYRAMIDS[1:])
@pytest.mark.parametrize("impl", ["level", "level_v2"])
def test_level_pyramid_gradient_matches_autograd(case, impl):
    """Gradient through the pyramid autograd.Function on the card under
    either route (one forward launch, one backward launch per level) vs
    autograd through the route's plain pyramid version: 1e-5 absolute on
    unit-scale gradients, 1e-4 relative (other summation order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    lead, h2, w2, levels = case
    pyr, coords = _mk_level_pyramid(levels + 7, lead, h2, w2, levels)
    g = torch.randn(lead + (49 * levels,), device="cuda",
                    generator=torch.Generator(device="cuda").manual_seed(3))
    a = [v.clone().requires_grad_(True) for v in pyr]
    tcorr.reset_launch_counts()
    tcorr.lookup_pyramid(a, coords, impl=impl).backward(g)
    counts = tcorr.launch_counts()
    live = sum(v.numel() > 0 for v in pyr)
    fwd, plain = {
        "level": ("lookup_level_fwd", tcorr.lookup_pyramid_level_reference),
        "level_v2": ("lookup_level_v2_fwd",
                     tcorr.lookup_pyramid_level_v2_reference)}[impl]
    assert counts[fwd] == 1
    assert counts["lookup_level_bwd"] == live
    b = [v.clone().requires_grad_(True) for v in pyr]
    auto = torch.autograd.grad(plain(b, coords), b, g)
    for x, y in zip(a, auto):
        torch.testing.assert_close(x.grad, y, atol=1e-5, rtol=1e-4)


@pytest.mark.cuda
def test_level_backward_kernel_matches_reference_and_autograd():
    """The backward kernel vs its plain version (same operation order:
    1e-5) and vs torch.autograd.grad through both plain forwards (other
    summation order: 1e-5 absolute on unit-scale gradients); the
    autograd.Function on CUDA tensors launches all of its kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    for seed, shape in enumerate(LEVEL_SHAPES):
        vol, coords, g = _mk_level(seed, shape)
        h2, w2 = shape[-2:]
        got = tcorr.lookup_level_backward_cuda(g, coords, h2, w2)
        want = tcorr.lookup_level_backward_reference(g, coords, h2, w2)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
        for ref in (tcorr.lookup_level_reference,
                    tcorr.lookup_level_v2_reference):
            v = vol.clone().requires_grad_(True)
            auto, = torch.autograd.grad(ref(v, coords), v, g)
            torch.testing.assert_close(got, auto, atol=1e-5, rtol=1e-4)
        for impl, fwd in (("level", "lookup_level_fwd"),
                          ("level_v2", "lookup_level_v2_fwd")):
            tcorr.reset_launch_counts()
            v = vol.clone().requires_grad_(True)
            out = tcorr.lookup_level(v, coords, impl=impl)
            out.backward(g)
            counts = tcorr.launch_counts()
            assert counts[fwd] == 1 and counts["lookup_level_bwd"] == 1
            torch.testing.assert_close(v.grad, want, atol=1e-5, rtol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("impl", ["level", "level_v2"])
def test_accumulate_step_cuda_matches_cpu(impl, monkeypatch):
    """One accumulate step of the training path on the card (lookup and
    its gradient through the CUDA kernels, cuDNN convolutions with TF32
    off) vs the CPU path (plain versions), shipped weights, 4 frames of
    64×96, 2 iterations, grad_clip's 0.01 threshold lifted so that no
    element flips across it: loss within 1e-4 relative, the gradient
    tree within 0.5% of its norm (f32 sums in another order).  Every
    lookup launches its kernels: one forward per iteration under either
    schedule (the whole pyramid), the backward one per iteration and level
    (2 iterations × 4 levels)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import os.path as osp

    from droid_slam_tpu_torch.config import TrainConfig
    from droid_slam_tpu_torch.data.synthetic import render_box_scene
    from droid_slam_tpu_torch.geom.graph_utils import temporal_graph
    from droid_slam_tpu_torch.models import convert, layers
    from droid_slam_tpu_torch.training import train_step as tts
    from droid_slam_tpu_torch.training.trainer import make_batch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    monkeypatch.setattr(layers, "GRAD_CLIP", 1e9)
    weights = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                       "weights", "droid_synth.npz")
    N, H, W = 4, 64, 96
    data = render_box_scene(N, H, W, seed=1, motion_scale=0.08)
    batch_np = dict(images=data["images"].astype(np.float32)[None],
                    poses=data["poses_c2w"][None],
                    disps=(1.0 / data["depths"])[None],
                    intrinsics=data["intrinsics"][None])
    ii, jj = temporal_graph(N, r=1)
    cfg = TrainConfig(image_size=(H, W), n_frames=N, steps=100)
    accum, _ = tts.make_train_step(iters=2)
    tcorr.set_lookup_impl(impl)
    out = {}
    try:
        for dev in ("cpu", "cuda"):
            state = tts.create_train_state(cfg, seed=0, device=dev)
            convert.load_weights(state.net, weights)
            batch = make_batch(batch_np, ii, jj, 8, dev)
            tcorr.reset_launch_counts()
            g, m = accum(tts.zero_grads(state.net), state.net, batch,
                         torch.zeros(1, N, 7, device=dev),
                         torch.zeros(1, N, H // 8, W // 8, device=dev))
            out[dev] = (float(m["loss"]),
                        {k: v.cpu() for k, v in g.items()},
                        tcorr.launch_counts())
    finally:
        tcorr.set_lookup_impl("level")
    fwd = "lookup_level_fwd" if impl == "level" else "lookup_level_v2_fwd"
    assert not any(out["cpu"][2].values())
    assert out["cuda"][2][fwd] == 2
    assert out["cuda"][2]["lookup_level_bwd"] == 8
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=1e-4)
    num = sum(((out["cuda"][1][k] - v) ** 2).sum()
              for k, v in out["cpu"][1].items())
    den = sum((v ** 2).sum() for v in out["cpu"][1].values())
    rel = float(torch.sqrt(num / den))
    print(f"{impl}: loss cpu {out['cpu'][0]} cuda {out['cuda'][0]}, "
          f"gradient tree relative difference {rel}")
    assert rel < 5e-3, rel


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [0, 1])
def test_scatter_repeats_bit_for_bit(dim):
    """`ops/scatter.index_add_` over a collision-heavy index on the card:
    two calls on the same inputs are bit-equal (where `index_add_`'s float
    atomics are not, ROADMAP C7), and agree with `index_add_` to f32
    rounding of the sums (atol 1e-3 on sums of ~3000 unit normals)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from droid_slam_tpu_torch.ops import scatter

    g = torch.Generator(device="cuda").manual_seed(0)
    idx = torch.randint(0, 64, (200000,), device="cuda", generator=g)
    src = torch.randn((200000, 36), device="cuda", generator=g)
    if dim == 1:
        src = src.T.contiguous()

    def run():
        shape = (64, 36) if dim == 0 else (36, 64)
        return scatter.index_add_(torch.zeros(shape, device="cuda"), dim,
                                  idx, src)

    a, b = run(), run()
    assert torch.equal(a, b)
    want = torch.zeros_like(a).index_add_(dim, idx, src)
    torch.testing.assert_close(a, want, atol=1e-3, rtol=1e-5)


@pytest.mark.cuda
def test_host_frontend_blocks_match_reference():
    """The host-driven frontend (`fused=False`) on the card launches the
    serving lookup kernel, and on its own edges, features and poses, in
    its 512-query blocks (30x40 queries), the kernel equals its plain
    version and the path's `edge_correlation` equals the kernel's taps
    (tolerance 0)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import os.path as osp

    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.data.synthetic import render_box_scene
    from droid_slam_tpu_torch.geom import projective
    from droid_slam_tpu_torch.runtime.factor_graph import (
        edge_correlation, target_fmaps)
    from droid_slam_tpu_torch.runtime.slam import Droid
    from droid_slam_tpu_torch.runtime.state import pool_pyramid

    weights = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                       "weights", "droid_synth.npz")
    scene = render_box_scene(12, 240, 320, seed=1, motion_scale=0.12)
    cfg = SLAMConfig(image_size=(240, 320), buffer=32, warmup=5,
                     filter_thresh=0.0, fused=False, corr_pixel_chunk=512)
    droid = Droid(cfg, weights_path=weights, device="cuda")
    tcorr.reset_launch_counts()
    for k, im in enumerate(scene["images"]):
        droid.track(float(k), im, intrinsics=scene["intrinsics"][0])
    assert droid.frontend.is_initialized and droid.frontend.count > 0
    assert tcorr.launch_counts()["corr_lookup"] > 0

    st = droid.video.state
    ii, jj = (torch.as_tensor(e, device="cuda")
              for e in droid.frontend.active_edges())
    E, HW = len(ii), droid.video.fht * droid.video.fwd
    coords1 = projective.projective_transform(
        st.poses[None], st.disps[None], st.intrinsics[None], ii, jj)[0][0]
    path = edge_correlation(st.fmaps, ii, jj, coords1, 512).reshape(
        E, HW, -1)
    f1 = st.fmaps[ii, 0].float().reshape(E, HW, -1) / 4.0
    f2 = [p.float() / 4.0
          for p in pool_pyramid(target_fmaps(st.fmaps, ii, jj))]
    cflat = coords1.reshape(E, HW, 2)
    for lo in range(0, HW, 512):
        vols = [torch.bmm(f1[:, lo:lo + 512],
                          p.reshape(E, -1, p.shape[-1]).transpose(1, 2))
                .to(torch.bfloat16).reshape((E, -1) + tuple(p.shape[1:3]))
                for p in f2]
        c = cflat[:, lo:lo + 512].contiguous()
        got = tcorr.lookup_pyramid_flat_cuda(vols, c)
        assert torch.equal(got, tcorr.lookup_pyramid_flat_reference(vols, c))
        assert torch.equal(path[:, lo:lo + 512], got)


@pytest.mark.cuda
def test_two_shard_ba_on_one_card_matches_single_device():
    """The distributed BA with two shards on the one card against the
    single-device BA on the card (tests/test_parallel.py's problem: poses
    atol 2e-4 / rtol 1e-3, disparities 2e-3 / 2e-2), and two distributed
    runs bit-equal (the shard sums add in a fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from droid_slam_tpu_torch.geom import projective
    from droid_slam_tpu_torch.lie import se3
    from droid_slam_tpu_torch.ops import dba
    from droid_slam_tpu_torch.parallel import dba as pdba

    rng = np.random.default_rng(0)
    T, BUF, ht, wd, t0 = 10, 16, 12, 16, 2
    xs = np.cumsum(0.05 * rng.standard_normal((T, 6)), axis=0)
    xs[0] = 0
    poses_gt = se3.exp(torch.zeros((BUF, 6))).cuda()
    poses_gt[:T] = se3.exp(torch.tensor(xs, dtype=torch.float32)).cuda()
    disps_gt = torch.tensor(0.6 + 0.25 * rng.random((BUF, ht, wd)),
                            dtype=torch.float32, device="cuda")
    intr = torch.tensor([[wd * 1.2, wd * 1.2, wd / 2, ht / 2]] * BUF,
                        device="cuda")
    ii, jj = np.meshgrid(np.arange(T), np.arange(T), indexing="ij")
    keep = (np.abs(ii - jj) >= 1) & (np.abs(ii - jj) <= 3)
    ii, jj = ii[keep], jj[keep]
    ii_t = torch.as_tensor(ii, device="cuda")
    jj_t = torch.as_tensor(jj, device="cuda")
    target = projective.projective_transform(
        poses_gt[None], disps_gt[None], intr[None], ii_t, jj_t)[0][0]
    weight = torch.ones_like(target)
    noise = 0.02 * rng.standard_normal((BUF, 6))
    noise[:2] = 0
    noise[T:] = 0
    poses0 = se3.retr(poses_gt, torch.tensor(noise, dtype=torch.float32,
                                             device="cuda"))
    disps0 = torch.ones_like(disps_gt)
    sens = torch.zeros_like(disps_gt)
    eta = torch.full_like(disps_gt, 1e-4)
    mask = np.ones(len(ii), bool)
    kw = dict(iters=2, lm=1e-5, ep=1e-2, P=16)

    kx, km = dba.build_schur_tables(ii, mask, t0, T, 16)
    p1, d1 = dba.ba(poses0, disps0, sens, intr, target, weight, eta, ii_t,
                    jj_t, torch.as_tensor(mask, device="cuda"),
                    torch.as_tensor(kx, device="cuda"),
                    torch.as_tensor(km, device="cuda"), t0, T, **kw)
    need_e, need_k = pdba.plan_shard_caps(ii, mask, t0, T, 2)
    shards = pdba.shard_edges_by_frame(ii, jj, mask, 2, need_e, need_k, t0,
                                       T)
    runs = [pdba.distributed_ba(poses0, disps0, sens, intr, eta, target,
                                weight, shards, ["cuda:0", "cuda:0"], t0, T,
                                **kw) for _ in range(2)]
    p2, d2 = runs[0]
    torch.testing.assert_close(p2, p1, atol=2e-4, rtol=1e-3)
    torch.testing.assert_close(d2, d1, atol=2e-3, rtol=2e-2)
    assert torch.equal(runs[1][0], p2) and torch.equal(runs[1][1], d2)


def _booted_droid(**kw):
    """`Droid` on the card at 96x128 after the five boot frames, with the
    frames of its synthetic scene."""
    import os.path as osp

    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.data.synthetic import render_box_scene
    from droid_slam_tpu_torch.runtime.slam import Droid

    weights = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                       "weights", "droid_synth.npz")
    scene = render_box_scene(12, 96, 128, seed=1, motion_scale=0.12)
    imgs, intr = scene["images"], scene["intrinsics"][0]
    cfg = SLAMConfig(image_size=(96, 128), buffer=32, warmup=5,
                     filter_thresh=0.0, **kw)
    droid = Droid(cfg, weights_path=weights, device="cuda")
    for k in range(5):
        droid.track(float(k), imgs[k], intrinsics=intr)
    assert droid.frontend.is_initialized
    return droid, imgs, intr


@pytest.mark.cuda
def test_ba_graph_replays_the_eager_static_path():
    """Each keyframe round's BA graph (captured at the boot) against the
    same static-shape BA run eagerly on the card, bit for bit, over rounds
    whose pose windows, masks and depth frames differ, the last frames
    after the GraphState's tensors were replaced; two replays of one
    round's inputs repeat bit for bit; every round replays (the tracer's
    `ba.replay` against `round.ba`) and none captures again."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import dataclasses

    from droid_slam_tpu_torch.utils import timers

    droid, imgs, intr = _booted_droid()
    step = droid.frontend.step
    graphed = step.ba
    assert graphed.graph is not None           # captured at the boot
    seen = []

    def both(tensors, idx):
        want = [t.clone() for t in step._round_ba(*tensors, idx)]
        got = [t.clone() for t in graphed(tensors, idx)]
        again = graphed(tensors, idx)
        seen.append((idx.cpu().numpy().tobytes(), all(
            torch.equal(a, b) and torch.equal(a, c)
            for a, b, c in zip(got, want, again))))
        return again

    step.ba = both
    timers.reset()
    timers.enable()
    try:
        for k in range(5, 12):
            if k == 9:
                g = droid.frontend.g
                droid.frontend.g = dataclasses.replace(
                    g, target=g.target.clone(), weight=g.weight.clone())
            droid.track(float(k), imgs[k], intrinsics=intr)
        counts = timers.counts()
    finally:
        timers.enable(False)
        timers.reset()
    assert len(seen) >= 12 and len({i for i, _ in seen}) >= 6
    assert all(eq for _, eq in seen), [eq for _, eq in seen]
    assert counts["ba.replay"] == 2 * counts["round.ba"] == 2 * len(seen)
    assert "ba.capture" not in counts


@pytest.mark.cuda
def test_ba_graph_and_its_eager_path_never_wait_for_the_card():
    """The static-shape BA run eagerly, and a replay of its graph, under
    `torch.cuda.set_sync_debug_mode("error")`: no call inside waits for
    the card (the upload of the round's indices lies outside)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    droid, _, _ = _booted_droid()
    step, g = droid.frontend.step, droid.frontend.g
    tensors = step._ba_inputs(g)
    idx, _ = step._indices(g, np.nonzero(g.active)[0])
    idx = idx[5 * step.EA:]
    assert idx.data_ptr() == step.ba.idx.data_ptr()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step._round_ba(*tensors, idx)
        step.ba.graph.replay()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("upsample", [False, True])
def test_update_graphs_replay_the_eager_operator(upsample):
    """The update operator's graphs, captured at the boot for every edge
    count, against the operator run eagerly on the same inputs, bit for
    bit, at several edge counts and segment layouts; a call whose segment
    count is not its edge count runs eagerly."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from droid_slam_tpu_torch.utils import timers

    droid, _, _ = _booted_droid(upsample=upsample)
    step = droid.frontend.step
    table = step.op_graphs
    assert sorted(table.graphs) == list(range(1, step.EA + 1))
    update = droid.net.update
    h, w = droid.video.fht, droid.video.fwd
    gen = torch.Generator(device="cuda").manual_seed(0)
    timers.reset()
    timers.enable()
    try:
        for E in (1, 2, 7, 23, step.EA):
            x = [torch.randn((E, h, w, c), device="cuda", generator=gen)
                 for c in (128, 128, 196, 4)]
            x[1] = x[1].to(droid.video.state.inps.dtype)
            ix = torch.randint(0, max(1, E // 3), (E,), device="cuda",
                               generator=gen)
            want = update(*x, ix=ix, nseg=E, with_upmask=upsample)
            got = update(*x, ix=ix, nseg=E, with_upmask=upsample,
                         graphs=table)
            assert len(got) == len(want) == 4 + upsample
            assert all(torch.equal(a, b) for a, b in zip(got, want)), E
            update(*x, ix=ix, nseg=E + 1, with_upmask=upsample,
                   graphs=table)
        counts = timers.counts()
    finally:
        timers.enable(False)
        timers.reset()
    assert counts["op.replay"] == 5


@pytest.mark.cuda
@pytest.mark.parametrize("cache_mb", [0, 512])
def test_a_keyframe_round_never_waits_for_the_card(cache_mb):
    """One update round of the fused step, from the upload of its indices
    to the BA's replay, with volumes correlated on the fly and cached,
    under `torch.cuda.set_sync_debug_mode("error")`: no call waits for the
    card, and the operator and the BA both replay their graphs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from droid_slam_tpu_torch.runtime import fused
    from droid_slam_tpu_torch.utils import timers

    droid, _, _ = _booted_droid(corr_cache_mb=cache_mb)
    step, g = droid.frontend.step, droid.frontend.g
    assert step.cache_vols == (cache_mb > 0)
    act = np.nonzero(g.active)[0]
    vols = None
    if step.cache_vols:
        vols = fused.edge_volumes(droid.video.state.fmaps,
                                  torch.as_tensor(g.ii[act], device="cuda"),
                                  torch.as_tensor(g.jj[act], device="cuda"))
    step.upload.last = None          # the round uploads its indices anew
    torch.cuda.synchronize()
    timers.reset()
    timers.enable()
    torch.cuda.set_sync_debug_mode("error")
    try:
        step.update_round(g, vols)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        timers.enable(False)
    counts = timers.counts()
    timers.reset()
    torch.cuda.synchronize()
    assert counts["op.replay"] == counts["ba.replay"] == 1
    assert not [k for k in counts if k.startswith("sync.")], counts


@pytest.mark.cuda
def test_tracer_records_under_a_cuda_only_profiler():
    """The benchmark's profiler (CUDA activity only) switches the tracer
    on and off, and the tracer adds no event to its device trace."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from droid_slam_tpu_torch.utils import timers

    timers.reset()
    x = torch.ones(8, device="cuda")
    try:
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            assert timers.recording()
            with timers.span("probe"):
                with timers.sync_site("probe.item"):
                    x.sum().item()
        assert not timers.recording()
        assert timers.span("probe") is timers._NULL
        assert timers.counts() == {"probe": 1, "sync.probe.item": 1}
        names = {e.name() for e in prof.profiler.kineto_results.events()}
        assert not {"probe", "sync.probe.item"} & names
    finally:
        timers.reset()


def _waits(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn") with the tracer
    on: (its result, synchronizing calls warned of, host waits counted by
    the sync sites)."""
    import warnings

    from droid_slam_tpu_torch.utils import timers

    def counted():
        return sum(n for k, n in timers.counts().items()
                   if k.startswith("sync."))

    timers.enable()
    before = counted()
    # the mode switches stay outside the record: the first one can warn
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            out = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
        timers.enable(False)
    warned = [w for w in seen if "synchronizing" in str(w.message)]
    return out, len(warned), counted() - before


@pytest.mark.cuda
@pytest.mark.parametrize("cache_mb", [0, 512])
def test_every_host_wait_of_a_frame_is_a_counted_sync_site(cache_mb):
    """A keyframe step and a gate frame of the fused path on the card,
    with volumes correlated on the fly (as in the benchmark's tracking
    cells) and cached: every synchronizing call lies inside a sync site
    that counts it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    import os.path as osp

    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.data.synthetic import render_box_scene
    from droid_slam_tpu_torch.runtime.slam import Droid
    from droid_slam_tpu_torch.utils import timers

    weights = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))),
                       "weights", "droid_synth.npz")
    scene = render_box_scene(8, 96, 128, seed=1, motion_scale=0.12)
    imgs, intr = scene["images"], scene["intrinsics"][0]
    cfg = SLAMConfig(image_size=(96, 128), buffer=32, warmup=5,
                     filter_thresh=0.0, corr_cache_mb=cache_mb)
    droid = Droid(cfg, weights_path=weights, device="cuda")
    for k in range(5):
        droid.track(float(k), imgs[k], intrinsics=intr)
    assert droid.frontend.is_initialized
    assert droid.frontend.step.cache_vols == (cache_mb > 0)
    timers.reset()
    try:
        for k, thresh, want in ((5, 0.0, True), (6, 1e9, False)):
            droid.frontend.filter_thresh = thresh
            kf, warned, counted = _waits(
                lambda: droid.track(float(k), imgs[k], intrinsics=intr))
            assert kf == want
            assert warned > 0 and counted == warned, (k, warned, counted)
        counts = timers.counts()
    finally:
        timers.reset()
    # the rounds wait nowhere: their indices go up in one upload without
    # a wait, GraphAgg and the BA read them on the card
    assert not {"sync.segments.unique", "sync.graphagg.mask",
                "sync.graphagg.bincount", "sync.h2d.ba"} & set(counts)
    assert counts["op.replay"] == counts["round.update_op"] >= 4


@pytest.mark.cuda
def test_every_host_wait_of_an_accumulate_pass_is_a_counted_sync_site():
    """One accumulate pass (unrolled forward and backward) on the card:
    every synchronizing call lies inside a sync site that counts it."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from droid_slam_tpu_torch.config import TrainConfig
    from droid_slam_tpu_torch.data.synthetic import render_plane_scene
    from droid_slam_tpu_torch.geom.graph_utils import temporal_graph
    from droid_slam_tpu_torch.training import train_step as tts
    from droid_slam_tpu_torch.training import trainer
    from droid_slam_tpu_torch.utils import timers

    N, H, W = 4, 64, 96
    data = render_plane_scene(8, H, W, seed=0)
    batch_np = dict(images=data["images"][:N].astype(np.float32)[None],
                    poses=data["poses_c2w"][:N][None],
                    disps=(1.0 / data["depths"][:N])[None],
                    intrinsics=data["intrinsics"][:N][None])
    ii, jj = temporal_graph(N, r=1)
    cfg = TrainConfig(image_size=(H, W), n_frames=N, steps=100)
    state = tts.create_train_state(cfg, seed=0, device="cuda")
    accum, _ = tts.make_train_step(iters=3)
    timers.reset()
    try:
        batch, warned_b, counted_b = _waits(
            lambda: trainer.make_batch(batch_np, ii, jj, 8, "cuda"))
        _, warned, counted = _waits(lambda: accum(
            tts.zero_grads(state.net), state.net, batch,
            torch.zeros(1, N, 7, device="cuda"),
            torch.zeros(1, N, H // 8, W // 8, device="cuda")))
        assert warned_b > 0 and counted_b == warned_b
        assert warned > 0 and counted == warned, (warned, counted)
    finally:
        timers.reset()
