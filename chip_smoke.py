"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

1. Builds the CUDA kernels of droid_slam_tpu_torch from csrc/ anew (one
   nvcc per source, side by side).
2. Kernel phases: holds each kernel against its plain PyTorch version on
   the card (atol = rtol = 1e-5) and times the kernel, the plain version
   and one PyTorch library call computing the same function (CUDA events
   around back-to-back calls, median after warm-up), and computes the
   kernel's bound (bytes or operations) from the run's coordinates.
   Seeded coordinates: the identity grid plus a small flow, as an update
   round gives them, with ~2% far out of bounds.
   a. The serving lookup at the shapes of the 240×320 main path (64
      edges, 4 pyramid levels of bf16 query-major planes), one launch
      per pyramid.
   b. The training lookups (two combines on the one-launch pyramid
      schedule, each also level by level in its one-level form) and their
      backward at the shapes of `TrainConfig()` (40 edge slots, 48×64
      queries, 4 levels of an f32 pyramid); the backward also against
      torch.autograd.grad through the plain forwards.
   Times are per 4-level pyramid; the backward serves one level per
   launch and is timed level by level and summed (a one-launch kernel
   has no per-level time; its levels list the bound and the library
   call).
3. Serving paths, each with the shipped weights, tracking a synthetic
   textured-box sequence frame by frame and terminating (global BA +
   trajectory fill); launch counts are reset just before each and read
   just after.  Each prints frames, filter passes, keyframes, tracking
   rate, terminate time, ATE after Sim(3) alignment (must stay under 10%
   of the path length), the alignment's scale, the path length, lookup
   launches and peak device memory:
   a. mono main path: `Droid(SLAMConfig())`, 80 frames at 240×320;
   b. stereo: `PRESETS["euroc"]` with `stereo=True`, 60 stereo pairs at
      320×512 (right camera 0.1 along the left one's x axis); also prints
      the ii == jj edges of the frontend graph and raises if there was
      none.  Then holds the serving lookup kernel against its plain
      version at this path's shapes, on the run's own features and poses:
      the on-the-fly volumes of the frontend edges at the frame with the
      most ii == jj edges (those read the right camera), in the keyframe
      step's 512-pixel query blocks, each block against the plain version
      and the path's `edge_correlation` against the kernel's taps;
   c. RGB-D: `PRESETS["eth3d"]` with `upsample=True`, 60 frames at 240×320
      with their exact depths; also prints how many keyframes' `disps_up`
      were written (raises if none) and their median relative inverse-
      depth error, and raises unless the alignment's scale is within 0.1
      of 1 (the depth prior fixes metric scale).
   d. cli path, through the user's entry point: the box scene rendered at
      480×640 (80 frames) is written as PNG files with a 4-value
      calib.txt, and `python -m droid_slam_tpu_torch.demo --imagedir ...
      --export_ply ... --output ...` runs as a subprocess on the card
      (its stream resizes to 384×512, the demo's default width; its
      launch counts start at 0 in the new process and its summary line
      reports them).  Raises unless the trajectory file holds one
      unit-quaternion pose per frame with an ATE after Sim(3) alignment
      under 10% of the path, the PLY has points and the lookup kernel was
      launched.  Then holds the lookup kernel against its plain version
      on this path's own 512-pixel query blocks (features and poses of an
      in-process run of the same stream, as in b) and times one block;
      prints keyframes, frames/s, terminate s, ATE, launches, peak
      memory, the block time and the PNG decode time per frame.
   e. tum eval path: `python -m droid_slam_tpu_torch.evaluate tum` on
      tests/fixtures/tum_tiny (10 frames, stride 1, warmup 5, filter 0)
      as a subprocess: undistortion, the 352×256 resize and the crop of
      the TUM stream without OpenCV; raises unless it prints a finite ATE
      over 10 poses.
4. Training main path at the full width of `TrainConfig()` (384×512, 7
   frames, 15 iterations, 40 edge slots, f32): `train(...)` for a few
   optimizer steps from a seeded initialisation on a small synthetic
   curriculum, then timed accumulate/apply steps on one fixed batch under
   both lookup schedules.  Launch counts are reset just before and read
   just after.  Raises unless every loss and gradient norm is finite,
   every training kernel was launched (either schedule once per pyramid
   forward, once per level backward), and the shipped weights
   reach a lower loss on the fixed batch than the seeded initialisation.  Prints
   step time, peak memory and launches per step.
5. Prints the card's name and power limit, one {"kernels": [...]} line,
   and as the last line {"ok": true, "device": {...}}.

Trajectory errors come from the package's own `geom/align.py`.  Any
failed phase raises, so the script exits non-zero.  It needs a CUDA
card: without one it exits 1 before printing any result.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet), for the bound: memory rate and the
# float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# f32 operations per query of the lookup: 8 rows x 7 x-blends and 49
# y-blends, two products and one sum each
LOOKUP_FLOPS_PER_QUERY = (8 * 7 + 49) * 3
RADIUS = 3
# frames of the serving phases: mono, and each of stereo and RGB-D
FRAMES = 80
FRAMES_STEREO_RGBD = 60
# the training main path: optimizer steps `train` takes, scenes it renders
TRAIN_STEPS = 3
TRAIN_SCENES = 3
TOL = dict(atol=1e-5, rtol=1e-5)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        raise RuntimeError("nvidia-smi failed: " + out.stderr)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, warmup=3, reps=10, batches=5):
    """Time of one call: CUDA events around `reps` back-to-back calls,
    divided by `reps`; the median over `batches` such runs, after
    warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    return float(np.median(times))


def grid_sample_lookup(planes, coords):
    """One library call for the same windowed lookup: bilinear
    grid_sample with zero padding of (Q, 1, h2, w2) planes at a 7×7 grid
    per query (align_corners=True maps pixel indices exactly).  Planes and
    grid are float32: grid_sample wants one dtype for both, and a bf16
    grid would quantize the sample positions."""
    from torch.nn import functional as F

    Q, h2, w2 = planes.shape
    off = torch.arange(-RADIUS, RADIUS + 1, device=coords.device,
                       dtype=torch.float32)
    gx = coords[:, None, None, 0] + off[None, None, :]       # (Q,1,7) ox
    gy = coords[:, None, None, 1] + off[None, :, None]       # (Q,7,1) oy
    gx = 2.0 * gx / max(w2 - 1, 1) - 1.0
    gy = 2.0 * gy / max(h2 - 1, 1) - 1.0
    grid = torch.stack(torch.broadcast_tensors(gx, gy), dim=-1)
    out = F.grid_sample(planes[:, None], grid.to(planes.dtype),
                        mode="bilinear", padding_mode="zeros",
                        align_corners=True)                   # (Q,1,oy,ox)
    return out[:, 0].transpose(1, 2).reshape(Q, -1)


def window_bytes(coords, h2, w2, elem):
    """Least bytes one level of a lookup must read with these level-scale
    coordinates: the in-bounds window elements of each query (64 at
    most)."""
    x0 = torch.floor(coords[..., 0]).clamp(-2e4, 2e4).long()
    y0 = torch.floor(coords[..., 1]).clamp(-2e4, 2e4).long()
    offs = torch.arange(2 * RADIUS + 2, device=coords.device) - RADIUS
    nx = ((x0[..., None] + offs >= 0) & (x0[..., None] + offs < w2)).sum(-1)
    ny = ((y0[..., None] + offs >= 0) & (y0[..., None] + offs < h2)).sum(-1)
    return int((nx * ny).sum()) * elem


def lookup_bytes(coords, h2, w2, elem):
    """Least bytes of a one-level lookup: its window elements, 49 f32
    outputs and 8 coordinate bytes per query."""
    q = coords.numel() // 2
    return window_bytes(coords, h2, w2, elem) + q * 49 * 4 + q * 8


def pyramid_bytes(coords, planes, elem):
    """Least bytes of a one-launch pyramid lookup with these level-0
    coordinates: every level's window elements and 49 f32 outputs, and the
    coordinates once."""
    q = coords.numel() // 2
    return (sum(window_bytes(coords / 2 ** l, h2, w2, elem) + q * 49 * 4
                for l, (h2, w2) in enumerate(planes)) + q * 8)


def flow_coords(rng, E, h, w):
    """(E, h, w, 2) level-0 coordinates: the identity grid plus a flow of
    a few pixels, as an update round gives them; ~2% of the queries far
    out of bounds, as padded queries are."""
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    c = np.stack([gx, gy], -1)[None] + rng.normal(0.0, 2.0, (E, h, w, 2))
    c[rng.random((E, h, w)) < 0.02] = -1e4
    return torch.from_numpy(c.astype(np.float32)).cuda()


def bound_row(nbytes, ops):
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / F32_FLOPS_PER_S * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms), bytes=nbytes,
                bytes_ms=bytes_ms, ops_ms=ops_ms)


def check_equal(got, want):
    """The kernel against its plain version; returns max_abs_err."""
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, **TOL)
    return float((got - want).abs().max())


def kernel_phase(corr):
    """The serving lookup kernel at the main path's shapes: one launch per
    4-level pyramid of query-major bf16 planes."""
    E, h, w = 64, 30, 40                       # 240x320 at 1/8
    HW = h * w
    rng = np.random.default_rng(0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    planes = [(h >> l, w >> l) for l in range(4)]
    vols = [torch.randn((E, HW, h2, w2), device="cuda",
                        generator=gen).to(torch.bfloat16)
            for h2, w2 in planes]              # query-major, as cached
    coords = flow_coords(rng, E, h, w).reshape(E, HW, 2)

    got = corr.lookup_pyramid_flat_cuda(vols, coords)
    ref = corr.lookup_pyramid_flat_reference(vols, coords)
    report = dict(max_abs_err=check_equal(got, ref), library_ms=0.0,
                  library_max_abs_err=0.0, levels=[])
    report.update(bound_row(
        pyramid_bytes(coords, planes, vols[0].element_size()),
        4 * E * HW * LOOKUP_FLOPS_PER_QUERY))
    report["ms"] = cuda_time_ms(
        lambda: corr.lookup_pyramid_flat_cuda(vols, coords))
    report["plain_ms"] = cuda_time_ms(
        lambda: corr.lookup_pyramid_flat_reference(vols, coords), reps=5)
    # level by level: the library call (it takes one level) and the
    # level's share of the bound
    for lvl, vol in enumerate(vols):
        h2, w2 = planes[lvl]
        c = coords / 2 ** lvl
        flat = vol.reshape(E * HW, h2, w2).float()
        cflat = c.reshape(E * HW, 2)
        lib = grid_sample_lookup(flat, cflat).reshape(E, HW, -1)
        report["library_max_abs_err"] = max(
            report["library_max_abs_err"],
            float((lib - ref[..., 49 * lvl:49 * (lvl + 1)]).abs().max()))
        libms = cuda_time_ms(lambda: grid_sample_lookup(flat, cflat))
        row = dict(level=lvl, shape=[E, HW, h2, w2], library_ms=libms)
        row.update(bound_row(lookup_bytes(c, h2, w2, vol.element_size()),
                             E * HW * LOOKUP_FLOPS_PER_QUERY))
        report["levels"].append(row)
        report["library_ms"] += libms
        del flat, lib
    return report


def level_kernel_phase(corr):
    """The training lookups and their backward at TrainConfig() shapes."""
    from droid_slam_tpu_torch.ops.corr import (
        lookup_level_backward_cuda, lookup_level_backward_reference,
        lookup_level_cuda, lookup_level_reference, lookup_level_v2_cuda,
        lookup_level_v2_reference, lookup_pyramid_level_cuda,
        lookup_pyramid_level_reference, lookup_pyramid_level_v2_cuda,
        lookup_pyramid_level_v2_reference)

    E, h, w = 40, 48, 64                       # 384x512 at 1/8
    Q = E * h * w
    rng = np.random.default_rng(1)
    gen = torch.Generator(device="cuda").manual_seed(1)
    volume = torch.randn((1, E, h, w, h, w), device="cuda", generator=gen)
    pyramid = corr.build_pyramid(volume)
    del volume
    coords0 = flow_coords(rng, E, h, w)[None]
    keys = ("ms", "plain_ms", "library_ms", "bound_ms", "bytes_ms", "ops_ms",
            "max_abs_err")
    # forward kernel -> (pyramid wrapper, its plain version, one-level
    # wrapper, its plain version)
    forwards = {
        "lookup_level_fwd": (lookup_pyramid_level_cuda,
                             lookup_pyramid_level_reference,
                             lookup_level_cuda, lookup_level_reference),
        "lookup_level_v2_fwd": (lookup_pyramid_level_v2_cuda,
                                lookup_pyramid_level_v2_reference,
                                lookup_level_v2_cuda,
                                lookup_level_v2_reference)}
    names = tuple(forwards) + ("lookup_level_bwd",)
    report = {n: dict({k: 0.0 for k in keys}, levels=[]) for n in names}
    report["lookup_level_bwd"]["autograd_max_abs_err"] = 0.0

    # each forward: the whole pyramid in one launch
    fwd_bound = bound_row(
        pyramid_bytes(coords0, [v.shape[-2:] for v in pyramid],
                      pyramid[0].element_size()),
        4 * Q * LOOKUP_FLOPS_PER_QUERY)
    for name, (kern, plain, _, _) in forwards.items():
        rep = report[name]
        rep["max_abs_err"] = check_equal(kern(pyramid, coords0),
                                         plain(pyramid, coords0))
        rep.update(fwd_bound)
        rep["ms"] = cuda_time_ms(lambda: kern(pyramid, coords0))
        rep["plain_ms"] = cuda_time_ms(lambda: plain(pyramid, coords0),
                                       reps=3, batches=3)

    for lvl, vol in enumerate(pyramid):
        h2, w2 = vol.shape[-2:]
        coords = coords0 / 2 ** lvl
        g = torch.randn((1, E, h, w, 49), device="cuda", generator=gen)
        planes = vol.reshape(Q, h2, w2)
        cflat = coords.reshape(Q, 2)
        shape = [E, h, w, h2, w2]

        # the forwards' one-level forms at this level, the library call
        # (it takes one level) and the level's share of the bound
        libms = cuda_time_ms(lambda: grid_sample_lookup(planes, cflat))
        row = dict(level=lvl, shape=shape, library_ms=libms,
                   **bound_row(lookup_bytes(coords, h2, w2,
                                            vol.element_size()),
                               Q * LOOKUP_FLOPS_PER_QUERY))
        for name, (_, _, one, one_plain) in forwards.items():
            rep = report[name]
            rep["max_abs_err"] = max(rep["max_abs_err"], check_equal(
                one(vol, coords), one_plain(vol, coords)))
            rep["library_ms"] += libms
            rep["levels"].append(row)

        # backward: against its plain version and against autograd through
        # both plain forwards
        got = lookup_level_backward_cuda(g, coords, h2, w2)
        want = lookup_level_backward_reference(g, coords, h2, w2)
        err = check_equal(got, want)
        del want
        rep = report["lookup_level_bwd"]
        for ref in (lookup_level_reference, lookup_level_v2_reference):
            v = vol.detach().requires_grad_(True)
            auto, = torch.autograd.grad(ref(v, coords), v, g)
            torch.testing.assert_close(got, auto, atol=1e-5, rtol=1e-4)
            rep["autograd_max_abs_err"] = max(
                rep["autograd_max_abs_err"], float((got - auto).abs().max()))
            del v, auto
        del got
        # the library's gradient: autograd through grid_sample
        pl = planes.detach().requires_grad_(True)
        lib_out = grid_sample_lookup(pl, cflat)
        gflat = g.reshape(Q, 49)
        lib_bwd = cuda_time_ms(lambda: torch.autograd.grad(
            lib_out, pl, gflat, retain_graph=True), reps=3, batches=3)
        del lib_out, pl
        # least bytes of the dense gradient: written once, plus the tap
        # gradients and coordinates read once; 4 products and 3 sums per
        # window element
        bwd_bytes = Q * h2 * w2 * 4 + Q * 49 * 4 + Q * 8
        row = dict(level=lvl, shape=shape,
                   ms=cuda_time_ms(lambda: lookup_level_backward_cuda(
                       g, coords, h2, w2)),
                   plain_ms=cuda_time_ms(
                       lambda: lookup_level_backward_reference(
                           g, coords, h2, w2), reps=3, batches=3),
                   library_ms=lib_bwd,
                   **bound_row(bwd_bytes, Q * 64 * 7))
        rep["levels"].append(row)
        for k in keys[:-1]:
            rep[k] += row[k]
        rep["max_abs_err"] = max(rep["max_abs_err"], err)
        torch.cuda.empty_cache()
    return report


def training_phase(corr):
    """`train` and timed steps at the full width of TrainConfig()."""
    from droid_slam_tpu_torch.config import TrainConfig
    from droid_slam_tpu_torch.data.synthetic import SyntheticCurriculum
    from droid_slam_tpu_torch.geom.graph_utils import temporal_graph
    from droid_slam_tpu_torch.models.convert import load_weights
    from droid_slam_tpu_torch.training import train_step as tts
    from droid_slam_tpu_torch.training.trainer import (edge_capacity,
                                                       make_batch, train)

    t = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        cfg = TrainConfig(ckpt_dir=os.path.join(tmp, "ckpt"),
                          name="chip_smoke")
        H, W = cfg.image_size
        N = cfg.n_frames
        dataset = SyntheticCurriculum(cfg, n_scenes=TRAIN_SCENES)
        print(f"curriculum: {TRAIN_SCENES} scenes {H}x{W} rendered in "
              f"{time.time() - t:.1f} s", flush=True)

        torch.cuda.synchronize()
        corr.reset_launch_counts()
        t = time.time()
        state = train(cfg, dataset, max_steps=TRAIN_STEPS, seed=0,
                      log_every=1, log_dir=os.path.join(tmp, "runs"),
                      lookup_impl="level")
        torch.cuda.synchronize()
        t_train = time.time() - t
        with open(os.path.join(tmp, "runs", cfg.name,
                               "metrics.jsonl")) as f:
            logged = [json.loads(line) for line in f if line.strip()]
    launches_train = corr.launch_counts()
    if state.step != TRAIN_STEPS or not logged:
        raise RuntimeError(f"train took {state.step} steps, logged "
                           f"{len(logged)} records")
    # the logger averages every step's metrics: a non-finite step shows
    for rec in logged:
        bad = {k: v for k, v in rec.items() if not np.isfinite(v)}
        if bad:
            raise RuntimeError(f"non-finite training metrics: {bad}")

    # timed steps on one fixed batch, both lookup schedules
    batch_np = next(dataset.sample_batches(
        cfg.batch, rng=np.random.default_rng(7)))
    cap = edge_capacity(cfg)
    batch = make_batch(batch_np, *temporal_graph(N, r=2), cap, "cuda")
    h8, w8 = batch["disps"].shape[-2:]
    Gs0 = torch.zeros((cfg.batch, N, 7), device="cuda")
    disp0 = torch.zeros((cfg.batch, N, h8, w8), device="cuda")
    seeded = tts.create_train_state(cfg, seed=0, device="cuda")
    shipped = tts.create_train_state(cfg, seed=0, device="cuda")
    load_weights(shipped.net, "weights/droid_synth.npz")

    def timed_step(state, impl, remat=False, apply=True):
        corr.set_lookup_impl(impl)
        accum, apply_g = tts.make_train_step(
            iters=cfg.iters, fix_scale=cfg.fix_scale, remat=remat)
        before = corr.launch_counts()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        grads, m = accum(tts.zero_grads(state.net), state.net, batch, Gs0,
                         disp0)
        torch.cuda.synchronize()
        t_accum = time.time() - t0
        if apply:
            m.update(apply_g(state, grads))
        else:
            m["grad_norm"] = tts.global_norm(grads.values())
        torch.cuda.synchronize()
        after = corr.launch_counts()
        out = dict(impl=impl, remat=remat, loss=float(m["loss"]),
                   grad_norm=float(m["grad_norm"]),
                   grad_nonfinite_frac=float(m["grad_nonfinite_frac"]),
                   accum_s=t_accum, step_s=time.time() - t0,
                   peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   launches={k: after[k] - before[k] for k in after})
        if not (np.isfinite(out["loss"]) and np.isfinite(out["grad_norm"])):
            raise RuntimeError(f"non-finite training step: {out}")
        print("train step: " + json.dumps(out), flush=True)
        return out

    try:
        steps = [timed_step(seeded, "level"),            # warm-up
                 timed_step(seeded, "level"),
                 timed_step(seeded, "level_v2"),
                 timed_step(seeded, "level", remat=True)]
        fresh = tts.create_train_state(cfg, seed=0, device="cuda")
        loss_seeded = timed_step(fresh, "level_v2", apply=False)["loss"]
        loss_shipped = timed_step(shipped, "level_v2", apply=False)["loss"]
    finally:
        corr.set_lookup_impl("level")
    launches = corr.launch_counts()
    if not loss_shipped < loss_seeded:
        raise RuntimeError(f"shipped weights' loss {loss_shipped} is not "
                           f"below the seeded initialisation's "
                           f"{loss_seeded}")
    for name in ("lookup_level_fwd", "lookup_level_v2_fwd",
                 "lookup_level_bwd"):
        if launches[name] <= 0:
            raise RuntimeError(f"the training path never launched {name}")
    # under either schedule a pyramid is one forward launch, and one
    # backward launch per level
    for step, fwd in ((steps[1], "lookup_level_fwd"),
                      (steps[2], "lookup_level_v2_fwd")):
        per_step = step["launches"]
        if (per_step[fwd] != cfg.iters
                or per_step["lookup_level_bwd"] != 4 * cfg.iters):
            raise RuntimeError(f"{cfg.iters} iterations under "
                               f"{step['impl']} launched {per_step}")
    out = dict(train_steps=TRAIN_STEPS, train_s=t_train,
               launches_train=launches_train, logged=logged,
               step_s_level=steps[1]["step_s"],
               step_s_level_v2=steps[2]["step_s"],
               step_s_level_remat=steps[3]["step_s"],
               peak_mem_bytes=steps[1]["peak_mem_bytes"],
               peak_mem_bytes_remat=steps[3]["peak_mem_bytes"],
               launches_per_step=steps[1]["launches"],
               launches_per_step_level_v2=steps[2]["launches"],
               loss_seeded=loss_seeded, loss_shipped=loss_shipped,
               launches=launches)
    print("training path: " + json.dumps(out), flush=True)
    return out


def trajectory_error(label, traj, poses_c2w):
    """ATE after a Sim(3) alignment of traj (N, 7) to the ground truth,
    the alignment's scale and the path length; raises unless the ATE is
    under 10% of the path."""
    from droid_slam_tpu_torch.geom.align import ate_rmse, umeyama

    gt = np.asarray(poses_c2w, np.float64)[:, :3]
    ate = ate_rmse(gt, traj[:, :3])
    scale = umeyama(traj[:, :3], gt)[0]
    path = float(np.linalg.norm(np.diff(gt, axis=0), axis=1).sum())
    if not ate < 0.1 * path:
        raise RuntimeError(f"{label}: ATE {ate} exceeds 10% of the path "
                           f"{path}")
    return ate, scale, path


def serving_phase(corr, label, cfg, scene, with_depth=False):
    """`Droid(cfg)` with the shipped weights tracks `scene` frame by frame
    (with its exact depths when `with_depth`) and terminates (global BA +
    trajectory fill of the left or only camera); launch counts are reset
    just before and read just after.  Raises unless the trajectory is
    finite with unit quaternions, the frontend initialized, the lookup
    kernel launched, and the ATE after a Sim(3) alignment is under 10% of
    the path.  Returns the phase's readings, the Droid, and under stereo
    the frontend's active edges (ii, jj) at the frame with the most
    ii == jj edges."""
    from droid_slam_tpu_torch.runtime.slam import Droid

    images, intr = scene["images"], scene["intrinsics"][0]
    n_frames = len(images)
    depth = scene["depths"] if with_depth else [None] * n_frames
    droid = Droid(cfg, weights_path="weights/droid_synth.npz")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    corr.reset_launch_counts()
    self_edges, stereo_edges = [], None
    t = time.time()
    passed = 0
    for k in range(n_frames):
        passed += bool(droid.track(float(k), images[k], depth=depth[k],
                                   intrinsics=intr))
        if cfg.stereo:
            ii, jj = droid.frontend.active_edges()
            self_edges.append(int((ii == jj).sum()))
            if self_edges[-1] == max(self_edges):
                stereo_edges = (ii.copy(), jj.copy())
    torch.cuda.synchronize()
    t_track = time.time() - t
    n_kf = droid.video.counter
    launches_track = corr.launch_counts()["corr_lookup"]
    st = droid.video.state
    if cfg.upsample:
        up_written_track = int((st.disps_up[:n_kf] != 0).flatten(1).any(1)
                               .sum())
    t = time.time()
    traj = droid.terminate(
        ((float(k), images[k], intr) for k in range(n_frames)))
    torch.cuda.synchronize()
    t_term = time.time() - t
    launches = corr.launch_counts()["corr_lookup"]
    peak = torch.cuda.max_memory_allocated()

    if traj.shape != (n_frames, 7) or not np.all(np.isfinite(traj)):
        raise RuntimeError(f"{label}: bad trajectory: shape {traj.shape}, "
                           f"finite {np.all(np.isfinite(traj))}")
    qn = np.linalg.norm(traj[:, 3:], axis=-1)
    if np.abs(qn - 1).max() > 1e-3:
        raise RuntimeError(f"{label}: non-unit quaternions: "
                           f"{np.abs(qn - 1).max()}")
    if n_kf <= cfg.warmup:
        raise RuntimeError(f"{label}: only {n_kf} keyframes (warmup "
                           f"{cfg.warmup})")
    if launches <= 0:
        raise RuntimeError(f"{label}: the path never launched the lookup "
                           f"kernel")
    ate, scale, path = trajectory_error(label, traj, scene["poses_c2w"])
    out = dict(frames=n_frames, filter_passed=passed, keyframes=n_kf,
               track_s=t_track, track_fps=n_frames / t_track,
               terminate_s=t_term, ate_rmse=ate, sim3_scale=scale,
               path_length=path, lookup_launches_track=launches_track,
               lookup_launches=launches, peak_mem_bytes=peak)
    if cfg.stereo:
        out.update(ii_eq_jj_edges_max=max(self_edges),
                   frames_with_ii_eq_jj_edges=sum(e > 0 for e in self_edges))
    if cfg.upsample:
        n = droid.video.counter
        written = (st.disps_up[:n] != 0).flatten(1).any(1)
        # inverse depth of the written keyframes against the render's exact
        # depth at their timestamps
        ks = st.tstamp[:n][written].long().cpu().numpy()
        inv = st.disps_up[:n][written].cpu().numpy()
        gt_inv = 1.0 / scene["depths"][ks]
        out.update(disps_up_written_track=up_written_track,
                   disps_up_written=int(written.sum()),
                   disps_up_finite=bool(np.isfinite(inv).all()),
                   disps_up_rel_err_median=float(np.median(
                       np.abs(inv - gt_inv) / gt_inv)))
    return out, droid, stereo_edges


def block_kernel_check(corr, cfg, droid, ii, jj):
    """The serving lookup kernel at the shapes of a path that correlates
    on the fly, on the run's own features and poses: the volumes of the
    frontend edges (ii, jj), ii == jj ones read from the right camera, in
    the keyframe step's blocks of query pixels.  Holds the kernel against
    its plain version block by block and the path's `edge_correlation`
    against the kernel's taps; times one block."""
    from droid_slam_tpu_torch.geom import projective
    from droid_slam_tpu_torch.runtime.factor_graph import (
        corr_pixel_chunk, edge_correlation, target_fmaps)
    from droid_slam_tpu_torch.runtime.fused import fused_caps
    from droid_slam_tpu_torch.runtime.state import pool_pyramid

    st = droid.video.state
    h, w = droid.video.fht, droid.video.fwd
    ii = torch.as_tensor(ii, device="cuda")
    jj = torch.as_tensor(jj, device="cuda")
    E, HW = len(ii), h * w
    coords1 = projective.projective_transform(
        st.poses[None], st.disps[None], st.intrinsics[None], ii, jj)[0][0]
    # the keyframe step's blocking (corr.alt_lookup_pyramid's rule)
    chunk = corr_pixel_chunk(cfg, fused_caps(cfg)[5], HW)
    step = chunk if (HW > 1024 and 0 < chunk < HW) else HW
    path = edge_correlation(st.fmaps, ii, jj, coords1, chunk)
    path = path.reshape(E, HW, -1)
    f1 = st.fmaps[ii, 0].float().reshape(E, HW, -1) / 4.0
    f2 = [p.float() / 4.0 for p in pool_pyramid(target_fmaps(st.fmaps, ii,
                                                             jj))]
    cflat = coords1.reshape(E, HW, 2)
    err, blocks = 0.0, []
    for lo in range(0, HW, step):
        vols = [torch.bmm(f1[:, lo:lo + step],
                          p.reshape(E, -1, p.shape[-1]).transpose(1, 2))
                .to(torch.bfloat16).reshape((E, -1) + tuple(p.shape[1:3]))
                for p in f2]
        c = cflat[:, lo:lo + step].contiguous()
        got = corr.lookup_pyramid_flat_cuda(vols, c)
        err = max(err, check_equal(
            got, corr.lookup_pyramid_flat_reference(vols, c)))
        check_equal(path[:, lo:lo + step], got)
        blocks.append((vols, c))
    vols, c = blocks[0]
    return dict(edges=E, ii_eq_jj_edges=int((ii == jj).sum()),
                query_block=step, blocks=len(blocks),
                planes=[list(p.shape[1:3]) for p in f2], max_abs_err=err,
                block_ms=cuda_time_ms(
                    lambda: corr.lookup_pyramid_flat_cuda(vols, c)))


def main_path_phase(corr, n_frames):
    """The mono path: `SLAMConfig()` on the box scene."""
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.data.synthetic import render_box_scene

    cfg = SLAMConfig()
    H, W = cfg.image_size
    t = time.time()
    scene = render_box_scene(n_frames, H, W, seed=1, motion_scale=0.12)
    print(f"scene: {n_frames} frames {H}x{W} rendered in "
          f"{time.time() - t:.1f} s", flush=True)
    out = serving_phase(corr, "main path", cfg, scene)[0]
    print("main path: " + json.dumps(out), flush=True)
    return out


def stereo_phase(corr, n_frames):
    """The EuRoC preset with stereo input on the stereo box scene."""
    import dataclasses

    from droid_slam_tpu_torch.config import PRESETS
    from droid_slam_tpu_torch.data.synthetic import render_stereo_box_scene

    cfg = dataclasses.replace(PRESETS["euroc"], stereo=True)
    H, W = cfg.image_size
    t = time.time()
    scene = render_stereo_box_scene(n_frames, H, W, seed=2,
                                    motion_scale=0.12)
    print(f"stereo scene: {n_frames} pairs {H}x{W} rendered in "
          f"{time.time() - t:.1f} s", flush=True)
    out, droid, edges = serving_phase(corr, "stereo path", cfg, scene)
    if out["ii_eq_jj_edges_max"] <= 0:
        raise RuntimeError("stereo path: no ii == jj edge in the frontend "
                           "graph")
    # after the launch counts were read: these launches only compare
    out["kernel_check"] = block_kernel_check(corr, cfg, droid, *edges)
    print("stereo path: " + json.dumps(out), flush=True)
    return out


def rgbd_phase(corr, n_frames):
    """The ETH3D preset with depth input and convex upsampling on the box
    scene with its exact depths."""
    import dataclasses

    from droid_slam_tpu_torch.config import PRESETS
    from droid_slam_tpu_torch.data.synthetic import render_box_scene

    cfg = dataclasses.replace(PRESETS["eth3d"], upsample=True)
    H, W = cfg.image_size
    t = time.time()
    scene = render_box_scene(n_frames, H, W, seed=3, motion_scale=0.12)
    print(f"rgbd scene: {n_frames} frames {H}x{W} rendered in "
          f"{time.time() - t:.1f} s", flush=True)
    out = serving_phase(corr, "rgbd path", cfg, scene, with_depth=True)[0]
    print("rgbd path: " + json.dumps(out), flush=True)
    # the depth prior fixes metric scale: the alignment needs no rescaling
    if not abs(out["sim3_scale"] - 1.0) <= 0.1:
        raise RuntimeError(f"rgbd path: Sim(3) scale {out['sim3_scale']} "
                           f"is off 1 by more than 0.1")
    if out["disps_up_written"] <= 0 or not out["disps_up_finite"]:
        raise RuntimeError(f"rgbd path: disps_up written for "
                           f"{out['disps_up_written']} keyframes, finite "
                           f"{out['disps_up_finite']}")
    return out


def run_cli(args, label, timeout):
    """`python -m <args>` from the repository root; its standard output,
    raising with its output when it fails."""
    res = subprocess.run([sys.executable, "-m", *args], capture_output=True,
                         text=True, timeout=timeout)
    if res.returncode != 0:
        raise RuntimeError(f"{label}: exit {res.returncode}\n"
                           f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}")
    return res.stdout


def cli_path_phase(corr, n_frames):
    """The demo CLI on PNG files of the box scene at 480×640, as a
    subprocess on the card; then the lookup kernel on this path's own
    query blocks."""
    import dataclasses

    from droid_slam_tpu_torch.config import PRESETS
    from droid_slam_tpu_torch.data import image_io, streams
    from droid_slam_tpu_torch.data.synthetic import render_box_scene
    from droid_slam_tpu_torch.runtime.slam import Droid

    H, W = 480, 640
    t = time.time()
    scene = render_box_scene(n_frames, H, W, seed=1, motion_scale=0.12)
    print(f"cli scene: {n_frames} frames {H}x{W} rendered in "
          f"{time.time() - t:.1f} s", flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        imagedir = os.path.join(tmp, "images")
        os.makedirs(imagedir)
        paths = [image_io.write_png(os.path.join(imagedir, f"{k:06d}.png"),
                                    im) for k, im in enumerate(
                                        scene["images"])]
        calib = os.path.join(tmp, "calib.txt")
        np.savetxt(calib, scene["intrinsics"][0][None], fmt="%.6f")
        t = time.time()
        for p in paths:
            image_io.read_png(p)
        decode_ms = (time.time() - t) / n_frames * 1e3

        traj_path = os.path.join(tmp, "traj.txt")
        ply = os.path.join(tmp, "map.ply")
        t = time.time()
        stdout = run_cli(["droid_slam_tpu_torch.demo", "--imagedir",
                          imagedir, "--calib", calib, "--weights",
                          "weights/droid_synth.npz", "--export_ply", ply,
                          "--output", traj_path], "cli path", 600)
        wall_s = time.time() - t
        summary = json.loads(stdout.strip().splitlines()[-1])
        out_traj = np.loadtxt(traj_path)
        with open(ply) as f:
            n_points = int(f.read(200).splitlines()[2].split()[-1])

        if out_traj.shape != (n_frames, 8) or not np.isfinite(
                out_traj).all():
            raise RuntimeError(f"cli path: trajectory file of shape "
                               f"{out_traj.shape}, expected ({n_frames}, 8)")
        np.testing.assert_array_equal(out_traj[:, 0], np.arange(n_frames))
        qn = np.linalg.norm(out_traj[:, 4:], axis=-1)
        if np.abs(qn - 1).max() > 1e-3:
            raise RuntimeError(f"cli path: non-unit quaternions: "
                               f"{np.abs(qn - 1).max()}")
        ate, scale, path = trajectory_error("cli path", out_traj[:, 1:],
                                            scene["poses_c2w"])
        if n_points <= 0 or n_points != summary["ply_points"]:
            raise RuntimeError(f"cli path: PLY holds {n_points} points, the "
                               f"demo reported {summary['ply_points']}")
        launches = summary["launches"]["corr_lookup"]
        if launches <= 0:
            raise RuntimeError("cli path: the demo never launched the "
                               "lookup kernel")

        # this path's blocks: the same stream in-process, until its
        # frontend has run a few keyframe steps
        size = tuple(summary["image_size"])
        cfg = dataclasses.replace(PRESETS["demo"], image_size=size)
        droid = Droid(cfg, weights_path="weights/droid_synth.npz")
        steps = 0
        for k, image, intr in streams.directory_stream(
                imagedir, calib, target_area=size[0] * size[1]):
            is_kf = droid.track(k, image, intrinsics=intr)
            steps += int(is_kf and droid.frontend.is_initialized)
            if steps >= 3:
                break
        edges = droid.frontend.active_edges()
        if steps < 3 or len(edges[0]) == 0:
            raise RuntimeError(f"cli path: the in-process run took {steps} "
                               f"keyframe steps, {len(edges[0])} edges")
        check = block_kernel_check(corr, cfg, droid, *edges)
    out = dict(frames=n_frames, image_size=summary["image_size"],
               keyframes=summary["keyframes"],
               track_fps=n_frames / summary["track_s"],
               terminate_s=summary["terminate_s"], wall_s=wall_s,
               ate_rmse=ate, sim3_scale=scale, path_length=path,
               ply_points=n_points, lookup_launches=launches,
               launches=summary["launches"],
               peak_mem_bytes=summary["peak_mem_bytes"],
               stream_ms_per_frame=summary["stream_s"] / n_frames * 1e3,
               png_decode_ms_per_frame=decode_ms, kernel_check=check)
    print("cli path: " + json.dumps(out), flush=True)
    return out


def tum_eval_phase():
    """The TUM evaluation CLI on tests/fixtures/tum_tiny, as a
    subprocess on the card; and the PNG decode time of its camera files
    (rows mostly Paeth-filtered, the decoder's slow path)."""
    import glob
    import re

    from droid_slam_tpu_torch.data import image_io

    files = sorted(glob.glob("tests/fixtures/tum_tiny/rgb/*.png"))
    image_io.read_png(files[0])
    t = time.time()
    for f in files:
        image_io.read_png(f)
    decode_ms = (time.time() - t) / len(files) * 1e3
    t = time.time()
    stdout = run_cli(["droid_slam_tpu_torch.evaluate", "tum", "--datapath",
                      "tests/fixtures/tum_tiny", "--weights",
                      "weights/droid_synth.npz", "--stride", "1",
                      "--warmup", "5", "--filter_thresh", "0"],
                     "tum eval path", 300)
    line = stdout.strip().splitlines()[-1]
    m = re.search(r"ATE RMSE \(Sim3-aligned\) = (\S+) m over (\d+) poses",
                  line)
    if not m or not np.isfinite(float(m.group(1))) or int(m.group(2)) != 10:
        raise RuntimeError(f"tum eval path: expected a finite ATE over 10 "
                           f"poses, got: {line}")
    out = dict(ate_rmse=float(m.group(1)), poses=int(m.group(2)),
               wall_s=time.time() - t, png_decode_ms_per_frame=decode_ms,
               line=line)
    print("tum eval path: " + json.dumps(out), flush=True)
    return out


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1

    from droid_slam_tpu_torch.ops import corr
    from droid_slam_tpu_torch.ops.cuda_build import BUILD_LOG, build_all

    card = card_line()
    print(f"card: {card}", flush=True)
    t = time.time()
    built = build_all(force=True)
    print(f"kernel build ({', '.join(built)}): {time.time() - t:.1f} s",
          flush=True)
    for name in built:
        print(f"--- nvcc {name} ---\n{BUILD_LOG[name].strip()}", flush=True)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    kern = kernel_phase(corr)
    print("kernel phase: " + json.dumps(kern), flush=True)
    level = level_kernel_phase(corr)
    print("level kernel phase: " + json.dumps(level), flush=True)

    main = main_path_phase(corr, FRAMES)
    stereo = stereo_phase(corr, FRAMES_STEREO_RGBD)
    rgbd_phase(corr, FRAMES_STEREO_RGBD)
    cli = cli_path_phase(corr, FRAMES)
    tum_eval_phase()
    training = training_phase(corr)

    def bound_by(rep):
        return "bytes" if rep["bytes_ms"] >= rep["ops_ms"] else "operations"

    kernels = [dict(
        name="corr_lookup", route="cuda",
        source="droid_slam_tpu_torch/csrc/corr_lookup.cu",
        replaces="droid_slam_tpu/ops/corr_pallas.py:333 "
                 "(lookup_flat_pallas_v3)",
        launches=cli["lookup_launches"],
        launches_by_path=dict(mono=main["lookup_launches"],
                              stereo=stereo["lookup_launches"],
                              cli=cli["lookup_launches"]),
        max_abs_err=max(kern["max_abs_err"],
                        stereo["kernel_check"]["max_abs_err"],
                        cli["kernel_check"]["max_abs_err"]),
        ms=kern["ms"], plain_ms=kern["plain_ms"],
        bound_ms=kern["bound_ms"], bound_by=bound_by(kern),
        library_ms=kern["library_ms"],
        note="ms per 4-level pyramid lookup of 64 edges at 240x320 in "
             "one launch, identity grid plus a small flow; launches on "
             "the cli path (the demo at 384x512); max_abs_err also over "
             "the stereo and cli paths' blocks",
    )]
    replaces = {
        "lookup_level_fwd": "droid_slam_tpu/ops/corr_pallas.py:83 "
                            "(lookup_level_pallas)",
        "lookup_level_v2_fwd": "droid_slam_tpu/ops/corr_pallas.py:199 "
                               "(lookup_level_pallas_v2)",
        "lookup_level_bwd": "droid_slam_tpu/ops/corr.py:125 (gradient of "
                            "lookup_level, which JAX differentiates; no "
                            "Pallas kernel)"}
    for name, rep in level.items():
        kernels.append(dict(
            name=name, route="cuda",
            source="droid_slam_tpu_torch/csrc/corr_lookup_level.cu",
            replaces=replaces[name], launches=training["launches"][name],
            max_abs_err=rep["max_abs_err"], ms=rep["ms"],
            plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=bound_by(rep), library_ms=rep["library_ms"],
            note="ms per 4-level pyramid of 40 edge slots at 384x512 "
                 "(f32), identity grid plus a small flow",
        ))
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    os.chdir(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
