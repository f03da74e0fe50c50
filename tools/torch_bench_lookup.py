"""Time the pyramid lookup kernels on a CUDA card, optionally against other
builds of them, all in one process on one card.

    python tools/torch_bench_lookup.py [--baseline CHECKOUT] [--csrc DIR ...]

Shapes and coordinates are those of chip_smoke.py's kernel phases:
  * serving: 64 edges x 1200 queries (240x320 at 1/8), four levels of bf16
    query-major planes, `lookup_pyramid_flat_cuda`;
  * training: 40 edge slots x 48x64 queries (384x512 at 1/8), four levels
    of an f32 pyramid, `lookup_pyramid_level_cuda` (four-corner combine)
    and `lookup_pyramid_level_v2_cuda` (separable combine);
identity grid plus a 2 px flow, ~2% of the queries far out of bounds.

--csrc DIR   times the same entry points built from another source
             directory (a variant of csrc/ with the same C interface), for
             experiments such as a kernel without its stores.
--baseline   a checkout of an earlier revision of this repository with the
             same serving and four-corner pyramid entry points, whose
             separable lookup went level by level (`lookup_level_v2_cuda`
             on coordinates in level units).  Its separable lookup is
             timed twice: its kernel alone (four launches on pre-scaled
             coordinates) and the pyramid as its callers ran it
             (`lookup_pyramid(impl="level_v2")`: four divides, four
             launches, one concatenation).  Its taps must equal this
             tree's bit for bit.

Every candidate is timed in turns (a, b, ..., b, a, twice over), CUDA events
around 10 back-to-back calls, median of 5 after warm-up, and the four turns
are reported side by side.  Prints the card's name and power limit and one JSON
line.  Needs a CUDA card.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def load_package(name, root):
    """Import `root`/droid_slam_tpu_torch under the module name `name`, so
    that several checkouts (or several builds of one) live in one process."""
    pkg_dir = os.path.join(root, "droid_slam_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg_dir, "__init__.py"),
        submodule_search_locations=[pkg_dir])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    corr = importlib.import_module(name + ".ops.corr")
    build = importlib.import_module(name + ".ops.cuda_build")
    return corr, build


def cuda_time_ms(fn, warmup=3, reps=10, batches=5):
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


def flow_coords(rng, E, h, w):
    """(E, h*w, 2) level-0 coordinates: identity grid plus a 2 px flow,
    ~2% of the queries far out of bounds."""
    gy, gx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    grid = np.stack([gx, gy], -1).reshape(1, h * w, 2)
    c = grid + rng.normal(0.0, 2.0, (E, h * w, 2))
    c[rng.random((E, h * w)) < 0.02] = -1e4
    return torch.from_numpy(c.astype(np.float32)).cuda()


def serving_case():
    E, h, w = 64, 30, 40
    gen = torch.Generator(device="cuda").manual_seed(0)
    vols = [torch.randn((E, h * w, h >> l, w >> l), device="cuda",
                        generator=gen).to(torch.bfloat16) for l in range(4)]
    return vols, flow_coords(np.random.default_rng(0), E, h, w)


def training_case(corr):
    E, h, w = 40, 48, 64
    gen = torch.Generator(device="cuda").manual_seed(1)
    pyramid = corr.build_pyramid(
        torch.randn((1, E, h, w, h, w), device="cuda", generator=gen))
    coords = flow_coords(np.random.default_rng(1), E, h, w)
    return pyramid, coords.reshape(1, E, h, w, 2)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--baseline")
    ap.add_argument("--csrc", action="append", default=[])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_bench_lookup: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)

    corr, build = load_package("lookup_tree", ROOT)
    build.build_all(force=True)
    for name, log in build.BUILD_LOG.items():
        print(f"--- nvcc {name} ---\n{log.strip()}", flush=True)
    vols, c_serv = serving_case()
    pyramid, c_train = training_case(corr)
    want = dict(
        serving_ms=corr.lookup_pyramid_flat_cuda(vols, c_serv),
        training_ms=corr.lookup_pyramid_level_cuda(pyramid, c_train),
        training_v2_ms=corr.lookup_pyramid_level_v2_cuda(pyramid, c_train))
    torch.cuda.synchronize()
    plain = dict(
        serving_ms=corr.lookup_pyramid_flat_reference(vols, c_serv),
        training_ms=corr.lookup_pyramid_level_reference(pyramid, c_train),
        training_v2_ms=corr.lookup_pyramid_level_v2_reference(pyramid,
                                                              c_train))
    for k, got in want.items():
        if not torch.equal(got, plain[k]):
            raise RuntimeError(f"{k}: kernel differs from its plain version "
                               f"by {float((got - plain[k]).abs().max())}")
    del plain

    def calls(c):
        """The three pyramid lookups of package `c` on this tree's inputs."""
        return dict(
            serving_ms=lambda: c.lookup_pyramid_flat_cuda(vols, c_serv),
            training_ms=lambda: c.lookup_pyramid_level_cuda(pyramid, c_train),
            training_v2_ms=lambda: c.lookup_pyramid_level_v2_cuda(pyramid,
                                                                  c_train))

    # name -> {measure: call}
    cands = {"tree": calls(corr)}

    for k, csrc in enumerate(args.csrc):
        vcorr, vbuild = load_package(f"lookup_variant{k}", ROOT)
        vbuild.CSRC = os.path.abspath(csrc)
        vbuild.BUILD_DIR = os.path.join(vbuild.CSRC, "build")
        vbuild.build_all(force=True)
        for name, log in vbuild.BUILD_LOG.items():
            used = [ln for ln in log.splitlines() if "pyramid" not in ln
                    and ("Used" in ln or "spill" in ln)]
            print(f"--- nvcc {csrc} {name} ---\n" + "\n".join(used),
                  flush=True)
        cands[f"csrc:{csrc}"] = calls(vcorr)

    if args.baseline:
        bcorr, bbuild = load_package("lookup_baseline",
                                     os.path.abspath(args.baseline))
        bbuild.build_all(force=True)
        ct = [c_train / 2 ** l for l in range(4)]
        with torch.no_grad():
            got = dict(
                serving_ms=bcorr.lookup_pyramid_flat_cuda(vols, c_serv),
                training_ms=bcorr.lookup_pyramid_level_cuda(pyramid,
                                                            c_train),
                training_v2_ms=bcorr.lookup_pyramid(pyramid, c_train,
                                                    impl="level_v2"))
        torch.cuda.synchronize()
        for k, g in got.items():
            if not torch.equal(g, want[k]):
                raise RuntimeError(f"{k}: the baseline's taps differ from "
                                   f"this tree's")

        def base_v2_kernels():
            for v, c in zip(pyramid, ct):
                bcorr.lookup_level_v2_cuda(v, c)

        def base_v2_as_called():
            with torch.no_grad():
                bcorr.lookup_pyramid(pyramid, c_train, impl="level_v2")

        cands["baseline"] = dict(
            serving_ms=lambda: bcorr.lookup_pyramid_flat_cuda(vols, c_serv),
            training_ms=lambda: bcorr.lookup_pyramid_level_cuda(pyramid,
                                                                c_train),
            training_v2_ms=base_v2_kernels,
            training_v2_as_called_ms=base_v2_as_called)

    names = list(cands)
    times = {n: {k: [] for k in cands[n]} for n in names}
    for turn in (names, names[::-1]) * 2:
        for n in turn:
            for k, fn in cands[n].items():
                times[n][k].append(cuda_time_ms(fn))
    print(json.dumps(dict(card=card, times=times)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
