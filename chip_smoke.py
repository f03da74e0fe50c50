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
   a2. host frontend path: the same cell under `SLAMConfig(fused=False)`
      (the host-driven factor graph drives every keyframe step), twice,
      each after `Droid.prewarm()`; raises unless the two trajectories
      are bit-equal.  Prints the keyframes beside the fused main path's,
      the host-clock phase timers of the second run's tracking (warm ms
      per phase; the card is not synchronized, so a phase is launch and
      host-read time), and holds the lookup kernel against its plain
      version on that run's frontend edges (as in d).  Then serves that
      run's map with the live viewer on an ephemeral port of 127.0.0.1,
      fetches `/` and `/map.bin`, and raises unless the map parses, has a
      camera per keyframe and equals `map_snapshot`.  Last, in a fresh
      process with an empty build directory, `prewarm()` and the same
      stream: raises unless `prewarm` built and loaded every kernel
      source and no build ran after it returned.
   a3. distributed backend path: the main path's state, copied just
      before `terminate`, finished by the single-device backend (global
      BA passes of 7 and 12 sweeps), then twice by
      `Backend(distributed=True)` over `ba_mesh(devices=[cuda:0,
      cuda:0])`, two shards on the one card; then the first sharded BA
      call's inputs through both solvers once.  Raises unless all 19
      sweeps of each run went through the sharded solver, the two
      distributed runs are bit-equal, the one-call solvers agree within
      the CPU test's bounds (poses 2e-4 / 1e-3, disparities 2e-3 /
      2e-2, every pixel), and after the sweeps the poses are within 2e-3
      of the single-device ones and the median disparity within 2e-3.
      Prints the pose and disparity differences (quantiles, the pixels
      outside 2e-3 / 2e-2, the confidence and damping of the ten that
      drift most beside the medians), the seconds and the lookup
      launches of each.
   b. determinism (ROADMAP C7): the mono path three times each, in
      turns, with the row sums of dense BA and GraphAgg in a sorted order
      (ops/scatter.py, as the port runs) and with `index_add_`'s float
      atomics, then twice under `torch.use_deterministic_algorithms(True)`
      (`CUBLAS_WORKSPACE_CONFIG=:4096:8` is set before CUDA starts); two
      runs of each kind compared stage by stage (keyframe poses after
      every frame);
      prints the comparisons and every run's frames/s, and raises unless
      the sorted pair and the deterministic pair are bit-equal;
   c. pth path: the shipped npz written in the layout of the reference's
      droid.pth (torch names under the DDP `module.` prefix, 3-channel
      delta and weight heads) by an inverse key map, loaded through
      `Droid(weights_path=...)`: raises unless every parameter is
      bit-equal to the npz load and the mono trajectory is bit-equal to
      the main path's;
   d. stereo: `PRESETS["euroc"]` with `stereo=True`, 60 stereo pairs at
      320×512 (right camera 0.1 along the left one's x axis); also prints
      the ii == jj edges of the frontend graph and raises if there was
      none.  Then holds the serving lookup kernel against its plain
      version at this path's shapes, on the run's own features and poses:
      the on-the-fly volumes of the frontend edges at the frame with the
      most ii == jj edges (those read the right camera), in the keyframe
      step's 512-pixel query blocks, each block against the plain version
      and the path's `edge_correlation` against the kernel's taps; then
      runs the path again and raises unless the trajectory (and so the
      Sim(3) scale) is bit-equal;
   e. RGB-D: `PRESETS["eth3d"]` with `upsample=True`, 60 frames at 240×320
      with their exact depths; also prints how many keyframes' `disps_up`
      were written (raises if none) and their median relative inverse-
      depth error, and raises unless the alignment's scale is within 0.1
      of 1 (the depth prior fixes metric scale).
   f. cli path, through the user's entry point: the box scene rendered at
      480×640 (80 frames) is written as PNG files with a 4-value
      calib.txt, and `python -m droid_slam_tpu_torch.demo --imagedir ...
      --export_ply ... --output ...` runs as a subprocess on the card,
      twice (its stream resizes to 384×512, the demo's default width; its
      launch counts start at 0 in the new process and its summary line
      reports them).  Raises unless the two runs write the same
      trajectory file and point count, the trajectory holds one
      unit-quaternion pose per frame with an ATE after Sim(3) alignment
      under 10% of the path, the PLY has points and the lookup kernel was
      launched.  Then holds the lookup kernel against its plain version
      on this path's own 512-pixel query blocks (features and poses of an
      in-process run of the same stream, as in d) and times one block;
      prints keyframes, frames/s, terminate s, ATE, launches, peak
      memory, the block time and the PNG decode time per frame.
   g. tum eval path: `python -m droid_slam_tpu_torch.evaluate tum` on
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
5. tartan training path, through the user's entry point: two plane
   scenes of 32 frames at 480×640 (fx = fy = 320) written in TartanAir's
   layout by the port's writer, and `python -m droid_slam_tpu_torch.train
   --datapath ... --steps 3` as a subprocess on the card at
   `TrainConfig()` width (augmented 384×512 crops), fine-tuning the
   shipped weights (`--init_npz`).  Prints samples,
   distinct frames per sample's walk, graph build seconds, seconds per
   step, peak memory, the logged losses and the kernels' launches (raises
   unless the losses are finite, B2 launched a multiple of 15 times and
   B4 four times as often); then holds B2 and B4 against their plain
   versions on one batch of that root (its frame graph, seeded features,
   the first iteration's coordinates).
6. synthetic eval path: `python -m droid_slam_tpu_torch.evaluate
   synthetic --compare` (box scenes at 96×128, motion 0.12, seeds 11-14)
   with the shipped weights, whose median ATE must be below the seeded
   initialisation's, and with the checkpoint the tartan training path
   wrote, whose errors must be finite.
7. data-parallel training path: `python -m torch.distributed.run
   --nproc_per_node 2 -m droid_slam_tpu_torch.train --synthetic --batch 2
   --steps 2 --iters 4` as a subprocess, two ranks sharing the card (so
   gloo), against the same command as one process; `TrainConfig()` width,
   the unrolled iterations cut to 4 so that both ranks fit the card.
   Prints the backend, world size, seconds per step, peak memory and
   B2/B4 launches of every rank and of the single process, the losses,
   the step-1 gradients' relative L2 difference (AdamW's first moment in
   the step-1 checkpoints) and the parameter updates' after each step.
   Then the exact check: two gloo ranks on the card take the CLI's step
   1 on a sample each, in turns, and all-reduce, against the two
   samples' gradients summed in one fresh process with no process group
   (cuDNN deterministic on every side); it also reads the floor (that
   sum twice), what splitting the batch moves (the batch of two in one
   chain) and two planted faults (an average, a dropped rank).  Raises unless the losses are finite, the
   reduced gradient is within 1e-6 relative L2 of the in-process sum on
   both ranks, the CLI's step-1 losses agree within 2e-3 relative and
   its step-1 gradients within 0.1, every rank launched B2 and B4, and
   B2/B4 match their plain versions on rank 0's first batch.
8. Prints the card's name and power limit, one {"kernels": [...]} line,
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

# cuBLAS reads this when CUDA starts; with it, its algorithms repeat bit
# for bit (the determinism phase)
os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")

import numpy as np  # noqa: E402
import torch  # noqa: E402

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
WEIGHTS = "weights/droid_synth.npz"
# the TartanAir training path: scenes and frames the smoke writes at
# 480x640
TARTAN_SCENES = 2
TARTAN_FRAMES = 32
# held-out scenes of the synthetic accuracy harness
SYNTH_SEEDS = ["11", "12", "13", "14"]
# the data-parallel phase: unrolled iterations cut so that two ranks at
# TrainConfig() width share the one card comfortably; rendered scenes
DP_ITERS = 4
DP_SCENES = 3


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
    load_weights(shipped.net, WEIGHTS)

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


def serving_phase(corr, label, cfg, scene, with_depth=False,
                  weights=WEIGHTS, before_stream=None, before_terminate=None):
    """`Droid(cfg)` with the shipped weights tracks `scene` frame by frame
    (with its exact depths when `with_depth`) and terminates (global BA +
    trajectory fill of the left or only camera); launch counts are reset
    just before and read just after.  `before_stream(droid)` and
    `before_terminate(droid)` run, if given, just before the first frame
    and just before `terminate`, outside the timed spans; they launch no
    kernel.  Raises unless
    the trajectory is finite with unit quaternions, the frontend
    initialized, the lookup kernel launched, and the ATE after a Sim(3)
    alignment is under 10% of the path.  Returns the phase's readings,
    the Droid, and under stereo the frontend's active edges (ii, jj) at
    the frame with the most ii == jj edges, and the trajectory."""
    from droid_slam_tpu_torch.runtime.slam import Droid

    images, intr = scene["images"], scene["intrinsics"][0]
    n_frames = len(images)
    depth = scene["depths"] if with_depth else [None] * n_frames
    droid = Droid(cfg, weights_path=weights)
    if before_stream is not None:
        before_stream(droid)
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
    if before_terminate is not None:
        before_terminate(droid)
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
    return out, droid, stereo_edges, traj


def block_kernel_check(corr, cfg, droid, ii, jj, edge_chunk=None):
    """The serving lookup kernel at the shapes of a path that correlates
    on the fly, on the run's own features and poses: the volumes of the
    frontend edges (ii, jj), ii == jj ones read from the right camera, in
    the blocks of query pixels of the keyframe step (whose edges per
    update pass are `edge_chunk`, the fused step's active capacity by
    default).  Holds the kernel against its plain version block by block
    and the path's `edge_correlation` against the kernel's taps; times
    one block."""
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
    chunk = corr_pixel_chunk(
        cfg, fused_caps(cfg)[5] if edge_chunk is None else edge_chunk, HW)
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
    snap = {}

    def keep_state(droid):
        snap.update(state={f: t.clone() for f, t in
                           vars(droid.video.state).items()},
                    counter=droid.video.counter, net=droid.net, cfg=cfg)

    out, _, _, traj = serving_phase(corr, "main path", cfg, scene,
                                    before_terminate=keep_state)
    print("main path: " + json.dumps(out), flush=True)
    return out, scene, traj, snap


def prewarm_child(frames_npz, out_json):
    """In a fresh process, whose kernel libraries are neither loaded nor
    built (an empty build directory): `Droid(SLAMConfig(fused=False))`,
    `prewarm()`, then the stream of `frames_npz`.  Writes to `out_json`
    what was loaded before `prewarm`, what it built and loaded, and every
    build that ran after it returned."""
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.ops import corr, cuda_build
    from droid_slam_tpu_torch.runtime.slam import Droid

    data = np.load(frames_npz)
    build, builds = cuda_build._build, []
    with tempfile.TemporaryDirectory() as build_dir:
        cuda_build.BUILD_DIR = build_dir
        cuda_build._build = lambda names: builds.append(list(names)) or build(
            names)
        loaded_before = sorted(cuda_build._libs)
        droid = Droid(SLAMConfig(fused=False), weights_path=WEIGHTS)
        t = time.time()
        droid.prewarm()
        prewarm_s = time.time() - t
        by_prewarm, loaded = list(builds), sorted(cuda_build._libs)
        corr.reset_launch_counts()
        for k, image in enumerate(data["images"]):
            droid.track(float(k), image, intrinsics=data["intrinsics"])
        torch.cuda.synchronize()
        out = dict(source_names=cuda_build.source_names(),
                   loaded_before=loaded_before,
                   built_by_prewarm=sorted(n for b in by_prewarm for n in b),
                   loaded_after_prewarm=loaded, prewarm_s=prewarm_s,
                   builds_after_prewarm=builds[len(by_prewarm):],
                   frames=len(data["images"]),
                   keyframes=droid.video.counter,
                   lookup_launches=corr.launch_counts()["corr_lookup"])
    with open(out_json, "w") as f:
        json.dump(out, f)


def run_children(target, args_of, label, timeout):
    """Start `target(*args_of(i))` in len(args_of) fresh processes side by
    side and join them, each within `timeout` seconds; raises if one
    fails, and ends any that is still running."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in args_of]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=timeout)
            if p.is_alive():
                raise RuntimeError(f"{label}: a child ran past {timeout} s")
            if p.exitcode != 0:
                raise RuntimeError(f"{label}: a child exited {p.exitcode}")
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()


def prewarm_check(scene, tmp):
    """`prewarm_child` on the mono cell's frames; raises unless nothing was
    loaded before `prewarm`, it built and loaded every kernel source, no
    build ran after it returned and the stream launched the lookup."""
    frames = os.path.join(tmp, "frames.npz")
    np.savez(frames, images=scene["images"],
             intrinsics=scene["intrinsics"][0])
    res = os.path.join(tmp, "prewarm.json")
    run_children(prewarm_child, [(frames, res)], "prewarm check", 300)
    with open(res) as f:
        out = json.load(f)
    if (out["loaded_before"] or out["builds_after_prewarm"]
            or out["built_by_prewarm"] != out["source_names"]
            or out["loaded_after_prewarm"] != out["source_names"]
            or out["lookup_launches"] <= 0):
        raise RuntimeError(f"host frontend path: prewarm check {out}")
    return out


def host_frontend_phase(corr, scene, main):
    """The mono cell under `SLAMConfig(fused=False)`, the host-driven
    frontend, twice, each after `prewarm()`: raises unless the two
    trajectories are bit-equal (and what `serving_phase` requires).
    Reads the host-clock phase timers of the second run's tracking,
    holds the lookup kernel against its plain version on that run's
    frontend edges, then serves that run's map with the live viewer and
    raises unless /map.bin parses, has a camera per keyframe and equals
    `map_snapshot`.  Last, `prewarm_check` in a fresh process (this one
    has loaded every kernel already)."""
    import urllib.request

    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.runtime.viewer import (decode_map,
                                                     map_snapshot,
                                                     start_viewer)
    from droid_slam_tpu_torch.utils.timers import GLOBAL_TIMERS

    cfg = SLAMConfig(fused=False)
    seen = {}

    def before_stream(droid):
        droid.prewarm()
        GLOBAL_TIMERS.reset()

    def before_terminate(droid):
        seen.update(edges=droid.frontend.active_edges(),
                    timers=GLOBAL_TIMERS.summary())

    runs = [serving_phase(corr, "host frontend path", cfg, scene,
                          before_stream=before_stream,
                          before_terminate=before_terminate)
            for _ in range(2)]
    out, droid, _, traj = runs[1]
    out.update(fused_main_path_keyframes=main["keyframes"],
               repeat_max_traj_diff=float(np.abs(runs[0][3] - traj).max()),
               timers_warm_ms={k: v["warm_ms"]
                               for k, v in seen["timers"].items()},
               timers_count={k: v["count"]
                             for k, v in seen["timers"].items()},
               timers_note="host clock, no card sync: launch and host-read "
                           "time, not device time")
    # after the launch counts were read: these launches only compare
    out["kernel_check"] = block_kernel_check(
        corr, cfg, droid, *seen["edges"], edge_chunk=cfg.frontend_edge_cap)

    viewer = start_viewer(droid.video, port=0)
    try:
        base = f"http://127.0.0.1:{viewer.port}"
        page = urllib.request.urlopen(f"{base}/", timeout=30).read()
        raw = urllib.request.urlopen(f"{base}/map.bin", timeout=60).read()
    finally:
        viewer.close()
    got = decode_map(raw)
    want = map_snapshot(droid.video)
    out["viewer"] = dict(page_bytes=len(page), map_bytes=len(raw),
                         points=len(got[0]), cameras=len(got[2]),
                         equals_snapshot=all(
                             a.shape == b.shape and np.array_equal(a, b)
                             for a, b in zip(got, want)))
    with tempfile.TemporaryDirectory() as tmp:
        out["prewarm"] = prewarm_check(scene, tmp)
    print("host frontend path: " + json.dumps(out), flush=True)
    if out["repeat_max_traj_diff"] != 0.0:
        raise RuntimeError(f"host frontend path: a second run's trajectory "
                           f"differs by {out['repeat_max_traj_diff']}")
    v = out["viewer"]
    if (b"<html" not in page or v["cameras"] != droid.video.counter
            or not v["equals_snapshot"] or v["points"] <= 0):
        raise RuntimeError(f"host frontend path: viewer {v}")
    return out


def distributed_backend_phase(corr, snap):
    """The main path's state, copied just before `terminate`, finished
    (global BA passes of 7 and 12 sweeps) by the single-device backend,
    then twice by `Backend(distributed=True)` over two shards on the one
    card.  Then the first sharded BA call's inputs go through the sharded
    and the single-device solver once more, side by side.  Raises unless
    every sweep went through the sharded solver, the two distributed runs
    are bit-equal, the one-call solvers agree within the CPU test's bounds
    (poses atol 2e-4 / rtol 1e-3, every disparity atol 2e-3 / rtol 2e-2),
    and after the 19 sweeps the poses agree within 2e-3 and the median
    disparity within 2e-3.  The sweeps feed each BA's result back through
    the update operator, so single pixels drift further; the line shows
    the confidence and damping of the pixels that drift most beside the
    medians."""
    from droid_slam_tpu_torch.ops import dba as dba_ops
    from droid_slam_tpu_torch.parallel import dba as pdba
    from droid_slam_tpu_torch.parallel.launch import ba_mesh
    from droid_slam_tpu_torch.runtime.backend import Backend
    from droid_slam_tpu_torch.runtime.state import DepthVideo

    cfg, n = snap["cfg"], snap["counter"]
    mesh = ba_mesh(devices=["cuda:0", "cuda:0"])
    solve = pdba.distributed_ba
    calls, first, last = [], {}, {}

    def traced(*a, **k):
        if not first:
            first.update(args=[x.clone() if torch.is_tensor(x) else x
                               for x in a], kw=k)
        # per-pixel confidence of the last call: the mean weight of the
        # edges leaving each keyframe, summed over them
        weight, shards = a[6], a[7]
        conf = torch.zeros((n,) + weight.shape[1:3], device=weight.device)
        for ii_s, rows_s, m_s in zip(shards[0], shards[2], shards[3]):
            conf.index_add_(0, torch.as_tensor(ii_s[m_s], device="cuda"),
                            weight[torch.as_tensor(rows_s[m_s],
                                                   device="cuda")].mean(-1))
        last.update(conf=conf)
        calls.append(1)
        return solve(*a, **k)

    pdba.distributed_ba = traced

    def finish(distributed):
        video = DepthVideo(cfg, "cuda")
        for f, t in snap["state"].items():
            getattr(video.state, f).copy_(t)
        video.counter = n
        backend = Backend(snap["net"], video, cfg, distributed=distributed,
                          mesh=mesh)
        torch.cuda.synchronize()
        corr.reset_launch_counts()
        t = time.time()
        for steps in (7, 12):
            backend(steps)
        torch.cuda.synchronize()
        return dict(poses=video.state.poses[:n].clone(),
                    disps=video.state.disps[:n].clone(),
                    damping=video.state.damping[:n].clone(),
                    s=time.time() - t,
                    launches=corr.launch_counts()["corr_lookup"])

    try:
        single = finish(False)
        n_single = len(calls)
        dist = [finish(True) for _ in range(2)]
    finally:
        pdba.distributed_ba = solve

    # one BA call, the same inputs through both solvers
    args, kw = first["args"], first["kw"]
    (poses, disps, disps_sens, intr, eta, target, weight, shards, devices,
     t0, t1) = args
    ii_s, jj_s, rows_s, m_s = shards[:4]
    E = target.shape[0]
    ii_f, jj_f = np.zeros(E, np.int64), np.zeros(E, np.int64)
    m_f = np.zeros(E, bool)
    for s in range(len(ii_s)):
        r = rows_s[s][m_s[s]]
        ii_f[r], jj_f[r], m_f[r] = ii_s[s][m_s[s]], jj_s[s][m_s[s]], True
    kx, kmask = dba_ops.build_schur_tables(ii_f, m_f, t0, t1, kw["P"])
    p_dist, d_dist = solve(*args, **kw)
    p_one, d_one = dba_ops.ba(
        poses, disps, disps_sens, intr, target, weight, eta,
        *(torch.as_tensor(x, device="cuda") for x in (ii_f, jj_f, m_f, kx,
                                                       kmask)),
        t0, t1, iters=kw["iters"], lm=kw["lm"], ep=kw["ep"], P=kw["P"])

    def outside(a, b, atol, rtol):
        return int(((a - b).abs() > atol + rtol * b.abs()).sum())

    dd = (dist[0]["disps"] - single["disps"]).abs()
    worst = torch.topk(dd.flatten(), 10).indices
    conf, damp = last["conf"].flatten(), single["damping"].flatten()
    out = dict(
        keyframes=n, shards=len(mesh), sharded_ba_calls=len(calls),
        single_calls=n_single,
        one_call=dict(
            edges=int(m_f.sum()),
            max_pose_diff=float((p_dist - p_one).abs().max()),
            poses_outside_bound=outside(p_dist, p_one, 2e-4, 1e-3),
            max_disp_diff=float((d_dist - d_one).abs().max()),
            disps_outside_bound=outside(d_dist, d_one, 2e-3, 2e-2)),
        max_pose_diff=float((dist[0]["poses"] - single["poses"])
                            .abs().max()),
        max_disp_diff=float(dd.max()),
        median_disp_diff=float(dd.median()),
        disp_diff_quantiles={q: float(torch.quantile(dd.flatten(), q))
                             for q in (0.9, 0.99, 0.999)},
        pixels=dd.numel(),
        pixels_outside_disp_tol=outside(dist[0]["disps"], single["disps"],
                                        2e-3, 2e-2),
        worst_pixels=dict(
            disp_diff=dd.flatten()[worst].tolist(),
            disp_single=single["disps"].flatten()[worst].tolist(),
            confidence=conf[worst].tolist(),
            damping=damp[worst].tolist()),
        median_confidence=float(conf.median()),
        median_damping=float(damp.median()),
        repeat_bit_equal=bool(
            torch.equal(dist[0]["poses"], dist[1]["poses"])
            and torch.equal(dist[0]["disps"], dist[1]["disps"])),
        backend_s_single=single["s"],
        backend_s_distributed=[d["s"] for d in dist],
        lookup_launches_single=single["launches"],
        lookup_launches=dist[0]["launches"])
    print("distributed backend path: " + json.dumps(out), flush=True)
    if n_single or len(calls) != 2 * 19:
        raise RuntimeError(f"distributed backend path: {len(calls)} sharded "
                           f"BA calls ({n_single} single), want 2 x 19")
    one = out["one_call"]
    if one["poses_outside_bound"] or one["disps_outside_bound"]:
        raise RuntimeError(f"distributed backend path: one BA call off the "
                           f"single-device solver: {one}")
    if not (out["max_pose_diff"] < 2e-3 and out["median_disp_diff"] < 2e-3
            and out["repeat_bit_equal"]):
        raise RuntimeError(f"distributed backend path: poses off the "
                           f"single-device backend by "
                           f"{out['max_pose_diff']} (bound 2e-3), the median "
                           f"disparity by {out['median_disp_diff']} (bound "
                           f"2e-3), or the two runs differ: {out}")
    if out["lookup_launches"] <= 0:
        raise RuntimeError("distributed backend path: no lookup launch")
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
    out, droid, edges, traj = serving_phase(corr, "stereo path", cfg,
                                            scene)
    if out["ii_eq_jj_edges_max"] <= 0:
        raise RuntimeError("stereo path: no ii == jj edge in the frontend "
                           "graph")
    # after the launch counts were read: these launches only compare
    out["kernel_check"] = block_kernel_check(corr, cfg, droid, *edges)
    del droid
    # the card repeats a run bit for bit (ROADMAP C7): so does the scale
    again = serving_phase(corr, "stereo path", cfg, scene)
    out["repeat_max_traj_diff"] = float(np.abs(again[3] - traj).max())
    out["repeat_sim3_scale"] = again[0]["sim3_scale"]
    print("stereo path: " + json.dumps(out), flush=True)
    if out["repeat_max_traj_diff"] != 0.0:
        raise RuntimeError(f"stereo path: a second run's trajectory differs "
                           f"by {out['repeat_max_traj_diff']}")
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


def run_cli(args, label, timeout, cwd=None):
    """`python -m <args>` (run from `cwd`, the repository root by default,
    with this checkout importable); its standard output, raising with its
    output when it fails."""
    env = dict(os.environ, PYTHONPATH=os.getcwd())
    # a session of its own: a timeout ends the child and everything it
    # started (torch.distributed.run's ranks)
    proc = subprocess.Popen([sys.executable, "-m", *args],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, cwd=cwd, env=env,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, 9)
        proc.communicate()
        raise
    if proc.returncode != 0:
        raise RuntimeError(f"{label}: exit {proc.returncode}\n"
                           f"{out[-4000:]}\n{err[-4000:]}")
    return out


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

        # twice: the card repeats a run bit for bit (ROADMAP C7), so the
        # two trajectory files and point clouds are the same
        runs = []
        for r in range(2):
            traj_path = os.path.join(tmp, f"traj{r}.txt")
            ply = os.path.join(tmp, f"map{r}.ply")
            t = time.time()
            stdout = run_cli(["droid_slam_tpu_torch.demo", "--imagedir",
                              imagedir, "--calib", calib, "--weights",
                              WEIGHTS, "--export_ply", ply,
                              "--output", traj_path], "cli path", 600)
            with open(traj_path) as f, open(ply) as g:
                runs.append(dict(wall_s=time.time() - t, traj=f.read(),
                                 n_points=int(g.read(200).splitlines()[2]
                                              .split()[-1]),
                                 summary=json.loads(
                                     stdout.strip().splitlines()[-1])))
        if (runs[1]["traj"] != runs[0]["traj"]
                or runs[1]["n_points"] != runs[0]["n_points"]):
            raise RuntimeError(f"cli path: a second run differs: PLY "
                               f"{runs[0]['n_points']} / "
                               f"{runs[1]['n_points']} points, trajectory "
                               f"files equal "
                               f"{runs[1]['traj'] == runs[0]['traj']}")
        wall_s, n_points = runs[0]["wall_s"], runs[0]["n_points"]
        summary = runs[0]["summary"]
        out_traj = np.loadtxt(os.path.join(tmp, "traj0.txt"))

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
        droid = Droid(cfg, weights_path=WEIGHTS)
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
               png_decode_ms_per_frame=decode_ms, kernel_check=check,
               repeat_bit_equal=True)
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
                      WEIGHTS, "--stride", "1",
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


def mono_run(cfg, scene):
    """`Droid(cfg)` on `scene` frame by frame: the keyframe poses after
    every frame (copied to the host), the tracking rate and the
    trajectory after terminate."""
    from droid_slam_tpu_torch.runtime.slam import Droid

    images, intr = scene["images"], scene["intrinsics"][0]
    droid = Droid(cfg, weights_path=WEIGHTS)
    torch.cuda.synchronize()
    snaps = []
    t = time.time()
    for k, im in enumerate(images):
        droid.track(float(k), im, intrinsics=intr)
        snaps.append(droid.video.state.poses[:droid.video.counter].cpu())
    torch.cuda.synchronize()
    fps = len(images) / (time.time() - t)
    traj = droid.terminate((float(k), im, intr)
                           for k, im in enumerate(images))
    return snaps, traj, fps


def compare_runs(a, b):
    """Two `mono_run`s stage by stage: the first frame after which their
    keyframe poses differ (None if never), the largest difference while
    their keyframe counts agree, both keyframe counts, and the largest
    difference of the two trajectories."""
    (sa, ta, _), (sb, tb, _) = a, b
    first, worst = None, 0.0
    for k, (x, y) in enumerate(zip(sa, sb)):
        if x.shape != y.shape:
            first = k if first is None else first
            break
        d = float((x - y).abs().max()) if x.numel() else 0.0
        if d > 0 and first is None:
            first = k
        worst = max(worst, d)
    return dict(first_frame_differing=first,
                max_pose_diff_while_counts_agree=worst,
                keyframes=[len(sa[-1]), len(sb[-1])],
                max_traj_diff=float(np.abs(ta - tb).max())
                if ta.shape == tb.shape else None)


def determinism_phase(scene):
    """ROADMAP C7: the mono path as the port runs it (row sums in a sorted
    order, ops/scatter.py) and with the float atomics of `index_add_` it
    had before, three runs each in turns (atomics, sorted, sorted,
    atomics, atomics, sorted), then twice under
    torch.use_deterministic_algorithms(True) (CUBLAS_WORKSPACE_CONFIG set
    before CUDA started); the first two runs of each kind compared stage
    by stage, and the tracking rate of every run.  Raises unless the
    sorted pair and the deterministic pair are bit-equal."""
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.ops import scatter

    cfg = SLAMConfig()
    sorted_add = scatter.index_add_

    def atomic_add(out, dim, index, source):
        return out.index_add_(dim, index, source)

    runs = {"atomic": [], "sorted": []}
    for kind in ("atomic", "sorted", "sorted", "atomic", "atomic",
                 "sorted"):
        scatter.index_add_ = atomic_add if kind == "atomic" else sorted_add
        try:
            runs[kind].append(mono_run(cfg, scene))
        finally:
            scatter.index_add_ = sorted_add
    torch.use_deterministic_algorithms(True)
    try:
        det = [mono_run(cfg, scene) for _ in range(2)]
    finally:
        torch.use_deterministic_algorithms(False)
    out = dict(sorted=compare_runs(*runs["sorted"][:2]),
               atomic=compare_runs(*runs["atomic"][:2]),
               deterministic=compare_runs(*det),
               fps_sorted=[r[2] for r in runs["sorted"]],
               fps_atomic=[r[2] for r in runs["atomic"]],
               fps_deterministic=[r[2] for r in det])
    print("determinism: " + json.dumps(out), flush=True)
    for mode in ("sorted", "deterministic"):
        if out[mode]["first_frame_differing"] is not None:
            raise RuntimeError(f"determinism: two {mode} runs differ: "
                               f"{out[mode]}")
    return out


def reference_state_dict(npz):
    """The npz's values in the layout of the reference's published
    droid.pth: torch module names under the DDP `module.` prefix, OIHW
    weights, and 3-channel delta and weight heads (the third channel
    seeded values that the import must drop)."""
    from droid_slam_tpu_torch.models.convert import load_npz_weights

    def name(path):
        head, *rest = path
        out = [head]
        for part in rest:
            if head != "update" and part.startswith("layer"):
                out += part.split("_")            # layer1_0 -> layer1.0
            elif part in ("downsample", "eta", "upmask"):
                out += [part, "0"]
            elif head == "update" and part[-2:] in ("_0", "_2"):
                out += [part[:-2], part[-1]]      # delta_2 -> delta.2
            else:
                out.append(part)
        return ".".join(out)

    rng = np.random.default_rng(0)
    sd = {}

    def walk(node, path):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, path + (k,))
                continue
            mod = name(path)
            t = torch.from_numpy(np.ascontiguousarray(
                v.transpose(3, 2, 0, 1) if k == "kernel" else v))
            if mod in ("update.delta.2", "update.weight.2"):
                extra = rng.standard_normal((1,) + tuple(t.shape[1:]))
                t = torch.cat([t, torch.from_numpy(extra).float()])
            sd[f"module.{mod}.{'weight' if k == 'kernel' else 'bias'}"] = t

    walk(load_npz_weights(npz), ())
    return sd


def pth_path_phase(corr, scene, npz_traj, tol):
    """The npz written as the reference's droid.pth, loaded through
    `Droid(weights_path=...)` on the card: every parameter bit-equal to
    the npz load, and the mono scene tracked to the npz run's trajectory
    within `tol`."""
    from droid_slam_tpu_torch.config import SLAMConfig
    from droid_slam_tpu_torch.models.convert import load_weights
    from droid_slam_tpu_torch.models.droidnet import DroidNet

    with tempfile.TemporaryDirectory() as tmp:
        pth = os.path.join(tmp, "droid.pth")
        torch.save(reference_state_dict(WEIGHTS), pth)
        want = load_weights(DroidNet(), WEIGHTS).state_dict()
        got = load_weights(DroidNet(), pth).state_dict()
        if set(got) != set(want) or len(got) != 102:
            raise RuntimeError(f"pth path: {len(got)} parameters, "
                               f"{len(set(got) ^ set(want))} names differ")
        unequal = [k for k in want if not torch.equal(got[k], want[k])]
        if unequal:
            raise RuntimeError(f"pth path: parameters differ from the npz "
                               f"load: {unequal}")
        out, droid, _, traj = serving_phase(corr, "pth path", SLAMConfig(),
                                            scene, weights=pth)
    out["params_bit_equal"] = len(want)
    out["max_traj_diff_vs_npz"] = float(np.abs(traj - npz_traj).max())
    print("pth path: " + json.dumps(out), flush=True)
    if not out["max_traj_diff_vs_npz"] <= tol:
        raise RuntimeError(f"pth path: trajectory differs from the npz "
                           f"run's by {out['max_traj_diff_vs_npz']} (> "
                           f"{tol})")
    return out


def tartan_kernel_check(corr, batch_np, cfg):
    """B2 and B4 on one batch of the TartanAir path's own data: the
    trainer's frame graph, seeded features of the batch's images, and the
    first iteration's coordinates (frame 0 at its ground-truth pose, the
    others at frame 1's, unit disparities); B2 against its plain version
    over the pyramid, B4 level by level against its plain version."""
    from droid_slam_tpu_torch.geom import projective
    from droid_slam_tpu_torch.geom.graph_utils import build_frame_graph
    from droid_slam_tpu_torch.lie import se3
    from droid_slam_tpu_torch.models.droidnet import DroidNet, random_init
    from droid_slam_tpu_torch.ops.corr import (
        lookup_level_backward_cuda, lookup_level_backward_reference,
        lookup_pyramid_level_cuda, lookup_pyramid_level_reference)

    ii, jj = build_frame_graph(batch_np["poses"], batch_np["disps"],
                               batch_np["intrinsics"], num=cfg.edges,
                               device="cuda")
    net = random_init(DroidNet(), 0).cuda().eval()
    images = torch.as_tensor(batch_np["images"], device="cuda")
    poses = torch.as_tensor(batch_np["poses"], device="cuda")
    intr8 = torch.as_tensor(batch_np["intrinsics"], device="cuda") / 8.0
    ii_t = torch.as_tensor(ii, device="cuda")
    jj_t = torch.as_tensor(jj, device="cuda")
    with torch.no_grad():
        fmaps = net.extract_features(images)[0]
        pyramid = corr.build_pyramid(corr.corr_volume(fmaps[:, ii_t],
                                                      fmaps[:, jj_t]))
        Ps = se3.inv(poses)
        N = Ps.shape[1]
        Gs = torch.cat([Ps[:, :1], Ps[:, 1:2].expand(-1, N - 1, -1)], 1)
        h8, w8 = fmaps.shape[2:4]
        coords = projective.projective_transform(
            Gs, torch.ones((1, N, h8, w8), device="cuda"), intr8, ii_t,
            jj_t)[0].contiguous()
        err_fwd = check_equal(lookup_pyramid_level_cuda(pyramid, coords),
                              lookup_pyramid_level_reference(pyramid,
                                                             coords))
        gen = torch.Generator(device="cuda").manual_seed(2)
        g = torch.randn(coords.shape[:-1] + (49,), device="cuda",
                        generator=gen)
        err_bwd = 0.0
        for lvl, vol in enumerate(pyramid):
            h2, w2 = vol.shape[-2:]
            c = coords / 2 ** lvl
            err_bwd = max(err_bwd, check_equal(
                lookup_level_backward_cuda(g, c, h2, w2),
                lookup_level_backward_reference(g, c, h2, w2)))
    return dict(edges=len(ii), volume=list(pyramid[0].shape),
                lookup_level_fwd_max_abs_err=err_fwd,
                lookup_level_bwd_max_abs_err=err_bwd)


def tartan_training_phase(corr, tmp):
    """The training CLI on a TartanAir root, as a subprocess on the card,
    then B2 and B4 on one batch of that root; returns the readings and
    the checkpoint the CLI wrote."""
    from droid_slam_tpu_torch.config import TrainConfig
    from droid_slam_tpu_torch.data.synthetic import write_tartanair_scene
    from droid_slam_tpu_torch.data.tartan import TartanAir

    cfg = TrainConfig()
    root = os.path.join(tmp, "tartanair")
    t = time.time()
    for s in range(TARTAN_SCENES):
        write_tartanair_scene(root, scene=f"synth/synth/Easy/P{s:03d}",
                              n_frames=TARTAN_FRAMES, H=480, W=640, seed=s,
                              focal=0.5, motion_scale=0.04)
    write_s = time.time() - t
    name, cache = "chip_smoke_tartan", os.path.join(tmp, "cache")
    ckpt_dir = os.path.join(tmp, "ckpt")
    t = time.time()
    # fine-tuning the shipped weights, as a user of the published
    # checkpoint would: the checkpoint then tracks (three steps from a
    # seeded initialisation leave weights that diverge on some scenes)
    stdout = run_cli(["droid_slam_tpu_torch.train", "--datapath", root,
                      "--init_npz", os.path.abspath(WEIGHTS),
                      "--steps", str(TRAIN_STEPS), "--ckpt_dir", ckpt_dir,
                      "--cache_dir", cache, "--log_every", "1",
                      "--name", name], "tartan training path", 600,
                     cwd=tmp)
    wall_s = time.time() - t
    summary = json.loads(stdout.strip().splitlines()[-1])
    with open(os.path.join(tmp, "runs", name, "metrics.jsonl")) as f:
        logged = [json.loads(line) for line in f if line.strip()]
    for rec in logged:
        bad = {k: v for k, v in rec.items() if not np.isfinite(v)}
        if bad:
            raise RuntimeError(f"tartan training path: non-finite metrics "
                               f"{bad}")
    launches = summary["launches"]
    fwd, bwd = launches["lookup_level_fwd"], launches["lookup_level_bwd"]
    # every accumulate pass (one or more per step, random restarts) is
    # one forward launch per iteration and one backward launch per level
    if (summary["steps"] != TRAIN_STEPS or not logged or fwd <= 0
            or fwd % cfg.iters or bwd != 4 * fwd):
        raise RuntimeError(f"tartan training path: {summary}, "
                           f"{len(logged)} logged records")

    ds = TartanAir(root, n_frames=cfg.n_frames, crop_size=cfg.image_size,
                   fmin=cfg.fmin, fmax=cfg.fmax, cache_dir=cache,
                   device="cuda")
    distinct = [len(set(ds.frame_indices(i, np.random.RandomState(i))[1]))
                for i in range(len(ds))]
    batch_np = next(ds.sample_batches(1, np.random.default_rng(0)))
    check = tartan_kernel_check(corr, batch_np, cfg)
    ckpt = os.path.join(ckpt_dir, f"step_{TRAIN_STEPS:06d}.pt")
    out = dict(scenes=TARTAN_SCENES, frames_per_scene=TARTAN_FRAMES,
               write_s=write_s, samples=summary["samples"],
               distinct_frames_per_sample=float(np.mean(distinct)),
               distinct_frames_min=int(min(distinct)),
               graph_build_s=summary["dataset_s"], wall_s=wall_s,
               train_s=summary["train_s"],
               s_per_step=summary["train_s"] / summary["steps"],
               loss=[rec["loss"] for rec in logged],
               peak_mem_bytes=summary["peak_mem_bytes"],
               launches=launches, kernel_check=check,
               checkpoint_written=os.path.isfile(ckpt))
    print("tartan training path: " + json.dumps(out), flush=True)
    if not out["checkpoint_written"] or out["distinct_frames_min"] < 2:
        raise RuntimeError("tartan training path: no checkpoint, or a "
                           "degenerate walk")
    return out, ckpt


def dp_train_config():
    """The data-parallel phase's `TrainConfig`, as the training CLI builds
    it from the phase's flags (`--fix_scale` not given)."""
    from droid_slam_tpu_torch.config import TrainConfig

    return TrainConfig(batch=2, steps=2, iters=DP_ITERS, fix_scale=False)


def dp_step1_gradient(batch_np, ii, jj, passes, remat=False):
    """The training CLI's step-1 gradient sum on `batch_np`: `passes`
    accumulate passes of its restart chain, each from the last one's
    estimates, from the seeded initialisation, before any all-reduce;
    returns (gradients on the card, metrics of the last pass)."""
    from droid_slam_tpu_torch.training import train_step as tts
    from droid_slam_tpu_torch.training.trainer import (edge_capacity,
                                                       make_batch)

    cfg = dp_train_config()
    net = tts.create_train_state(cfg, 0, "cuda").net
    batch = make_batch(batch_np, ii, jj, edge_capacity(cfg), "cuda")
    accum, _ = tts.make_train_step(iters=cfg.iters, fix_scale=cfg.fix_scale,
                                   remat=remat)
    B, N = batch["images"].shape[:2]
    h8, w8 = batch["disps"].shape[-2:]
    Gs0 = torch.zeros((B, N, 7), device="cuda")
    disp0 = torch.zeros((B, N, h8, w8), device="cuda")
    grads = tts.zero_grads(net)
    for _ in range(passes):
        grads, metrics = accum(grads, net, batch, Gs0, disp0)
        Gs0, disp0 = metrics.pop("_Gs_last"), metrics.pop("_disp_last")
    return grads, metrics


def flat_cpu(grads):
    """A gradient dict as one flat f32 tensor on the host, by name."""
    return torch.cat([v.reshape(-1).cpu() for _, v in sorted(grads.items())])


def deterministic(on):
    """cuDNN's deterministic algorithms and PyTorch's deterministic
    implementations where an op has one (warnings elsewhere)."""
    torch.backends.cudnn.deterministic = on
    torch.use_deterministic_algorithms(on, warn_only=True)


def dp_child_setup(batch_npz):
    """A fresh child's numerics as the smoke's (no TF32, deterministic
    algorithms) and the saved step-1 batch, graph and pass count."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    deterministic(True)
    data = np.load(batch_npz)
    batch = {k: data[k] for k in ("images", "poses", "disps", "intrinsics")}
    return batch, data["ii"], data["jj"], int(data["passes"])


def dp_rank_child(rank, port, batch_npz, out_path):
    """One of two ranks sharing the card, joined as torchrun would join
    them: `dp_step1_gradient` on this rank's slice of the batch, then the
    all-reduce; writes both gradients and the reduced loss.  The ranks
    take turns (a barrier, the cache emptied), so that each runs its
    first step as a process alone on the card does: side by side, a
    rank's gradient was not bit-equal to the same step taken alone."""
    from droid_slam_tpu_torch.parallel.launch import (initialize_distributed,
                                                      local_batch_slice)
    from droid_slam_tpu_torch.training import train_step as tts

    batch, ii, jj, passes = dp_child_setup(batch_npz)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE="2",
                      LOCAL_WORLD_SIZE="2", MASTER_ADDR="localhost",
                      MASTER_PORT=str(port))
    _, _, backend = initialize_distributed(torch.device("cuda", 0))
    sl = local_batch_slice(2)
    for turn in range(2):
        if turn == rank:
            grads, metrics = dp_step1_gradient(
                {k: v[sl] for k, v in batch.items()}, ii, jj, passes)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
        torch.distributed.barrier()
    local = flat_cpu(grads)
    grads, metrics = tts.all_reduce_gradients(grads, metrics)
    torch.save(dict(local=local, reduced=flat_cpu(grads),
                    loss=float(metrics["loss"]), backend=backend), out_path)
    torch.distributed.destroy_process_group()


def dp_reference_child(batch_npz, out_path):
    """The ranks' work in one fresh process with no process group: each
    sample's chain at the ranks' scale (the loss over the world size),
    twice; then the whole batch of two in one chain as the CLI's single
    process runs it (recomputing in the backward pass)."""
    from droid_slam_tpu_torch.training import train_step as tts

    batch, ii, jj, passes = dp_child_setup(batch_npz)
    tts.world_size = lambda: 2
    halves = [[dp_step1_gradient({k: v[i:i + 1] for k, v in batch.items()},
                                 ii, jj, passes) for i in range(2)]
              for _ in range(2)]
    out = dict(halves=[[flat_cpu(g) for g, _ in h] for h in halves],
               losses=[float(m["loss"]) for _, m in halves[0]])
    del halves
    tts.world_size = lambda: 1
    grads, metrics = dp_step1_gradient(batch, ii, jj, passes, remat=True)
    out.update(whole=flat_cpu(grads), whole_loss=float(metrics["loss"]))
    torch.save(out, out_path)


def dp_exact_check(tmp, batch_np):
    """The reduction of data-parallel training on the card, with nothing
    else between the sides.  Two gloo ranks sharing the card
    (`dp_rank_child`) take the CLI's step 1 (its batch, frame graph and
    restart passes, drawn from the CLI's seeds) on a sample each and
    all-reduce; then one fresh process (`dp_reference_child`) takes the
    same two samples' chains at the ranks' scale, with no process group,
    and sums them.  Every side runs cuDNN's deterministic algorithms.
    Also reads this process's own sum of the halves, the reference's
    floor (its sum twice), what splitting the batch moves (the batch of
    two in one chain) and two planted faults (an average for the sum, a
    rank dropped).  Raises unless both ranks hold the same gradient, it
    is bit-equal to the sum of the ranks' own gradients, and within 1e-6
    relative L2 of the reference's sum."""
    import socket

    from droid_slam_tpu_torch.geom.graph_utils import (build_frame_graph,
                                                       temporal_graph)
    from droid_slam_tpu_torch.training import train_step as tts

    cfg = dp_train_config()
    rng = np.random.default_rng([0, 0])           # the trainer's, seed 0
    if rng.random() < 0.5:
        ii, jj = build_frame_graph(batch_np["poses"], batch_np["disps"],
                                   batch_np["intrinsics"], num=cfg.edges,
                                   device="cuda")
    else:
        ii, jj = temporal_graph(cfg.n_frames, r=2)
    passes, r = 0, 0.0
    while r < cfg.restart_prob:
        r = rng.random()
        passes += 1
    path = os.path.join(tmp, "dp_batch.npz")
    np.savez(path, ii=ii, jj=jj, passes=passes, **batch_np)
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    outs = [os.path.join(tmp, f"dp_rank{k}.pt") for k in range(2)]
    t = time.time()
    run_children(dp_rank_child, [(k, port, path, outs[k]) for k in range(2)],
                 "data-parallel exact check", 600)
    ranks_s = time.time() - t
    ref_path = os.path.join(tmp, "dp_reference.pt")
    run_children(dp_reference_child, [(path, ref_path)],
                 "data-parallel exact check (reference)", 600)
    got = [torch.load(o, weights_only=True) for o in outs]
    ref = torch.load(ref_path, weights_only=True)

    # this process's own sum of the halves, for the reading only
    world = tts.world_size
    deterministic(True)
    try:
        tts.world_size = lambda: 2
        here = sum(flat_cpu(dp_step1_gradient(
            {k: v[i:i + 1] for k, v in batch_np.items()}, ii, jj,
            passes)[0]) for i in range(2))
    finally:
        tts.world_size = world
        deterministic(False)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    dp = got[0]["reduced"]
    halves = ref["halves"]
    sums = [h[0] + h[1] for h in halves]
    loss = sum(ref["losses"]) / 2
    out = dict(
        passes=passes, edges=len(ii), backend=got[0]["backend"],
        ranks_s=ranks_s,
        ranks_bit_equal=bool(torch.equal(dp, got[1]["reduced"])),
        reduced_bit_equal_to_local_sum=bool(torch.equal(
            dp, got[0]["local"] + got[1]["local"])),
        local_rel_l2_vs_reference=[rel(got[k]["local"], halves[0][k])
                                   for k in range(2)],
        rel_l2_vs_sum=rel(dp, sums[0]),
        max_abs_vs_sum=float((dp - sums[0]).abs().max()),
        bit_equal_to_sum=bool(torch.equal(dp, sums[0])),
        loss_rel_diff=abs(got[0]["loss"] - loss) / abs(loss),
        floor_rel_l2=rel(sums[1], sums[0]),
        this_process_rel_l2=rel(here, sums[0]),
        split_rel_l2=rel(sums[0], ref["whole"]),
        split_loss_rel_diff=abs(loss - ref["whole_loss"])
        / abs(ref["whole_loss"]),
        planted_average_rel_l2=rel(dp / 2, sums[0]),
        planted_rank_dropped_rel_l2=rel(halves[0][0], sums[0]))
    if (not out["ranks_bit_equal"] or out["backend"] != "gloo"
            or not out["reduced_bit_equal_to_local_sum"]
            or not out["rel_l2_vs_sum"] <= 1e-6):
        raise RuntimeError(f"data-parallel training path: the ranks' reduced "
                           f"gradient is off the in-process sum: {out}")
    return out


def data_parallel_phase(corr, tmp):
    """The training CLI data parallel: `torch.distributed.run
    --nproc_per_node 2` (two ranks sharing the card, so gloo) against one
    process, each with a global batch of 2 from the same seeds, at
    `TrainConfig()` width with the unrolled iterations cut to DP_ITERS so
    that both ranks fit the card beside each other.  Reads each run's
    rank summaries, the step-1 loss rank 0 prints, the step-1 gradient
    from the step-1 checkpoint (AdamW's first moment, (1 - beta1) times
    the clipped gradient) and the parameter update after both steps; then
    holds B2 and B4 against their plain versions on rank 0's first batch,
    and runs `dp_exact_check` on that batch.  Raises unless the losses
    are finite, B2/B4 ran on every rank and match their plain versions,
    the exact check passes (the reduction, bit for bit; within 1e-6 of
    one process's sum), and the CLI's step-1 losses agree within 2e-3
    relative and its step-1 gradients within 0.1 relative L2.  Those two
    bounds hold the rest of the CLI (its slicing, seeds and restart
    draws) coarsely: on this step splitting the batch alone moves the
    loss by 8.0e-4 and the gradient by 4.5% (the exact check's
    `split_*`), a dropped rank moves the gradient by 22% and an average
    for the sum by 50% (`planted_*`, read on an H100)."""
    import re

    from droid_slam_tpu_torch.config import TrainConfig
    from droid_slam_tpu_torch.data.synthetic import SyntheticCurriculum
    from droid_slam_tpu_torch.models.droidnet import DroidNet, random_init

    common = ["--synthetic", "--scenes", str(DP_SCENES), "--batch", "2",
              "--steps", "2", "--iters", str(DP_ITERS), "--log_every", "1",
              "--ckpt_every", "1"]

    def run(name, launcher):
        t = time.time()
        stdout = run_cli(launcher + ["droid_slam_tpu_torch.train", *common,
                                     "--ckpt_dir", name, "--name", name],
                         f"data-parallel training path ({name})", 900,
                         cwd=tmp)
        wall = time.time() - t
        ranks = sorted((json.loads(line) for line in stdout.splitlines()
                        if line.startswith('{"device"')),
                       key=lambda r: r["rank"])
        losses = [float(x) for x in re.findall(r"^step \d+: loss (\S+)",
                                               stdout, re.M)]
        ckpts = [torch.load(os.path.join(tmp, name, f"step_{k:06d}.pt"),
                            map_location="cpu", weights_only=True)
                 for k in (1, 2)]
        return dict(wall=wall, ranks=ranks, losses=losses, ckpts=ckpts)

    dp = run("dp", ["torch.distributed.run", "--standalone",
                    "--nproc_per_node", "2", "-m"])
    one = run("one", [])

    def flat(tensors):
        return torch.cat([t.reshape(-1).float() for t in tensors])

    def moments(ckpt):
        return flat(v["exp_avg"] for _, v in sorted(
            ckpt["opt"]["state"].items()))

    init = random_init(DroidNet(), 0).state_dict()

    def update(ckpt):
        return flat(ckpt["model"][k] - init[k] for k in init)

    def rel(a, b):
        return float((a - b).norm() / b.norm())

    ranks = dp["ranks"]
    out = dict(
        iters=DP_ITERS, scenes=DP_SCENES,
        reduced="unrolled iterations cut to fit two ranks on one card; "
                "width 384x512, 7 frames, as TrainConfig()",
        backend=ranks[0]["backend"], world_size=ranks[0]["world_size"],
        ranks=len(ranks), wall_s=dict(dp=dp["wall"], one=one["wall"]),
        s_per_step=dict(dp=[r["train_s"] / r["steps"] for r in ranks],
                        one=one["ranks"][0]["train_s"] / 2),
        peak_mem_bytes=dict(dp=[r["peak_mem_bytes"] for r in ranks],
                            one=one["ranks"][0]["peak_mem_bytes"]),
        launches=dict(dp=[r["launches"] for r in ranks],
                      one=one["ranks"][0]["launches"]),
        losses=dict(dp=dp["losses"], one=one["losses"]),
        step1_loss_rel_diff=abs(dp["losses"][0] - one["losses"][0])
        / abs(one["losses"][0]),
        step1_grad_rel_l2=rel(moments(dp["ckpts"][0]),
                              moments(one["ckpts"][0])),
        update_rel_l2=dict(step1=rel(update(dp["ckpts"][0]),
                                     update(one["ckpts"][0])),
                           step2=rel(update(dp["ckpts"][1]),
                                     update(one["ckpts"][1]))))

    cfg = TrainConfig()
    t = time.time()
    dataset = SyntheticCurriculum(cfg, n_scenes=DP_SCENES)
    batch_np = next(dataset.sample_batches(2, np.random.default_rng([1, 0])))
    rank0 = {k: v[:1] for k, v in batch_np.items()}
    out["kernel_check"] = tartan_kernel_check(corr, rank0, cfg)
    out["kernel_check"]["render_s"] = time.time() - t
    out["exact"] = dp_exact_check(tmp, batch_np)
    print("data-parallel training path: " + json.dumps(out), flush=True)

    kc = out["kernel_check"]
    if (out["world_size"] != 2 or len(ranks) != 2
            or out["backend"] != "gloo"
            or len(dp["losses"]) != 2 or len(one["losses"]) != 2
            or not np.all(np.isfinite(dp["losses"] + one["losses"]))):
        raise RuntimeError(f"data-parallel training path: {out}")
    if not (out["step1_loss_rel_diff"] < 2e-3
            and out["step1_grad_rel_l2"] < 0.1):
        raise RuntimeError(f"data-parallel training path: step 1 disagrees "
                           f"with one process: loss "
                           f"{out['step1_loss_rel_diff']}, gradient "
                           f"{out['step1_grad_rel_l2']}")
    for r in ranks:
        fwd, bwd = (r["launches"]["lookup_level_fwd"],
                    r["launches"]["lookup_level_bwd"])
        if fwd <= 0 or fwd % DP_ITERS or bwd != 4 * fwd:
            raise RuntimeError(f"data-parallel training path: rank "
                               f"{r['rank']} launches {r['launches']}")
    if (kc["lookup_level_fwd_max_abs_err"]
            or kc["lookup_level_bwd_max_abs_err"]):
        raise RuntimeError(f"data-parallel training path: B2/B4 differ from "
                           f"their plain versions on rank 0's batch: {kc}")
    return out


def synthetic_eval_phase(ckpt):
    """`evaluate synthetic --compare` with the shipped weights (their ATE
    must be below the seeded initialisation's), then with the training
    phase's checkpoint (finite errors), as subprocesses on the card."""
    import re

    def medians(stdout):
        return {m.group(1): float(m.group(2)) for m in re.finditer(
            r"^(learned|random-init) ATE[^:]*: median (\S+) m", stdout,
            re.M)}

    args = ["droid_slam_tpu_torch.evaluate", "synthetic", "--size", "96",
            "128", "--motion", "0.12", "--seeds", *SYNTH_SEEDS]
    t = time.time()
    shipped = medians(run_cli(args + ["--weights", WEIGHTS, "--compare"],
                              "synthetic eval path", 600))
    t_shipped = time.time() - t
    t = time.time()
    stdout = run_cli(args + ["--ckpt", ckpt], "synthetic eval path", 600)
    trained = medians(stdout)
    out = dict(seeds=[int(s) for s in SYNTH_SEEDS],
               shipped_ate_median=shipped.get("learned"),
               seeded_ate_median=shipped.get("random-init"),
               wall_s_compare=t_shipped,
               checkpoint_ate_median=trained.get("learned"),
               wall_s_checkpoint=time.time() - t,
               checkpoint_errors=[float(x) for x in re.findall(
                   r"ATE = (\S+) m", stdout)])
    print("synthetic eval path: " + json.dumps(out), flush=True)
    if not (out["shipped_ate_median"] is not None
            and out["seeded_ate_median"] is not None
            and out["shipped_ate_median"] < out["seeded_ate_median"]):
        raise RuntimeError(f"synthetic eval path: the shipped weights' ATE "
                           f"is not below the seeded initialisation's: "
                           f"{out}")
    errs = out["checkpoint_errors"]
    if len(errs) != len(SYNTH_SEEDS) or not np.all(np.isfinite(errs)):
        raise RuntimeError(f"synthetic eval path: checkpoint errors {errs}")
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

    main, scene, main_traj, main_snap = main_path_phase(corr, FRAMES)
    host = host_frontend_phase(corr, scene, main)
    dist = distributed_backend_phase(corr, main_snap)
    del main_snap
    determinism_phase(scene)
    pth = pth_path_phase(corr, scene, main_traj, tol=0.0)
    stereo = stereo_phase(corr, FRAMES_STEREO_RGBD)
    rgbd_phase(corr, FRAMES_STEREO_RGBD)
    cli = cli_path_phase(corr, FRAMES)
    tum_eval_phase()
    training = training_phase(corr)
    with tempfile.TemporaryDirectory() as tmp:
        tartan, ckpt = tartan_training_phase(corr, tmp)
        synthetic_eval_phase(ckpt)
    with tempfile.TemporaryDirectory() as tmp:
        dp = data_parallel_phase(corr, tmp)

    def bound_by(rep):
        return "bytes" if rep["bytes_ms"] >= rep["ops_ms"] else "operations"

    kernels = [dict(
        name="corr_lookup", route="cuda",
        source="droid_slam_tpu_torch/csrc/corr_lookup.cu",
        replaces="droid_slam_tpu/ops/corr_pallas.py:333 "
                 "(lookup_flat_pallas_v3)",
        launches=cli["lookup_launches"],
        launches_by_path=dict(mono=main["lookup_launches"],
                              pth=pth["lookup_launches"],
                              stereo=stereo["lookup_launches"],
                              cli=cli["lookup_launches"],
                              host=host["lookup_launches"],
                              distributed_backend=dist["lookup_launches"],
                              data_parallel=0),
        max_abs_err=max(kern["max_abs_err"],
                        stereo["kernel_check"]["max_abs_err"],
                        cli["kernel_check"]["max_abs_err"],
                        host["kernel_check"]["max_abs_err"]),
        ms=kern["ms"], plain_ms=kern["plain_ms"],
        bound_ms=kern["bound_ms"], bound_by=bound_by(kern),
        library_ms=kern["library_ms"],
        note="ms per 4-level pyramid lookup of 64 edges at 240x320 in "
             "one launch, identity grid plus a small flow; launches on "
             "the cli path (the demo at 384x512); max_abs_err also over "
             "the stereo, cli and host frontend paths' blocks",
    )]
    replaces = {
        "lookup_level_fwd": "droid_slam_tpu/ops/corr_pallas.py:83 "
                            "(lookup_level_pallas)",
        "lookup_level_v2_fwd": "droid_slam_tpu/ops/corr_pallas.py:199 "
                               "(lookup_level_pallas_v2)",
        "lookup_level_bwd": "droid_slam_tpu/ops/corr.py:125 (gradient of "
                            "lookup_level, which JAX differentiates; no "
                            "Pallas kernel)"}
    path_err = {
        name: max(tartan["kernel_check"][f"{name}_max_abs_err"],
                  dp["kernel_check"][f"{name}_max_abs_err"])
        for name in ("lookup_level_fwd", "lookup_level_bwd")}
    for name, rep in level.items():
        kernels.append(dict(
            name=name, route="cuda",
            source="droid_slam_tpu_torch/csrc/corr_lookup_level.cu",
            replaces=replaces[name], launches=training["launches"][name],
            launches_by_path=dict(
                training=training["launches"][name],
                tartan=tartan["launches"][name],
                host=0, distributed_backend=0,
                data_parallel=sum(r[name] for r in dp["launches"]["dp"])),
            max_abs_err=max(rep["max_abs_err"], path_err.get(name, 0.0)),
            ms=rep["ms"],
            plain_ms=rep["plain_ms"], bound_ms=rep["bound_ms"],
            bound_by=bound_by(rep), library_ms=rep["library_ms"],
            note="ms per 4-level pyramid of 40 edge slots at 384x512 "
                 "(f32), identity grid plus a small flow; launches on "
                 "the training main path (data_parallel: both ranks); "
                 "max_abs_err also over a batch of the TartanAir path "
                 "and rank 0's batch of the data-parallel path (B2 and "
                 "B4)",
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
