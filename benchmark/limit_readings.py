"""Read a cell's compared numbers on many seeds in one process on the CUDA
card, for the program and, on the seeds asked, for its control: the
readings a limit is set from (PERF.md).  readings.py's loop, with four
differences: the control is read only on `--control-seeds`, a seed may
be given more than once (the training check does not repeat on the
card), `--all-rounds` raises a tracking cell's sample of rounds past
what its window holds, so that the check compares every round of the
window, and `--repeat-steps` reads a training cell's two ratios under each of
several repeat steps (the images' move that gives the reference's own
gap, the ratios' yardstick), the reference and the control run once.

    python3 benchmark/limit_readings.py --workload <cell> --seeds <n> ... \\
        [--control-seeds <n> ...] --seconds <s> [--all-rounds] \\
        [--repeat-steps <grey> ...] [--out <file.jsonl>]

Prints one JSON line a run.
"""

import argparse
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

ALL_ROUNDS = 10 ** 6


def repeat_readings(ctx, rec, steps, control):
    """A training cell's record read as runners/train.py's check reads
    it, under each repeat step in `steps`: {side: {step: numbers}} for
    the program and, with `control`, the TF32 reference, with each
    number's gap and the reference's own gap beside the ratio."""
    from benchmark.lib import loader
    from benchmark.reference import precision
    from benchmark.reference import training as ref
    from benchmark.reference.weights import load_net
    from benchmark.runners import train

    dev = ctx.device
    cfg = dict(ctx.config["train"])
    prog = rec["program"]
    base = [dict(batch=ref.make_batch(s, g[0], g[1], rec["edge_cap"], dev),
                 passes=len(l))
            for s, g, l in zip(rec["samples"], prog["graphs"],
                               prog["losses"])]
    weights = os.path.join(loader.ROOT, ctx.config["weights"])

    def reference(steps_in, tf32=False):
        with precision.tf32(tf32):
            return ref.run_steps(load_net(weights, dev), cfg, steps_in)

    want = reference(base)
    gnorm = {k: float(v.norm()) for k, v in want["grad1"].items()}
    med = float(np.median(list(gnorm.values())))
    moving = [k for k, v in gnorm.items() if v >= 1e-3 * med]
    sides = {"program": prog}
    if control:
        sides["control"] = reference(base, tf32=True)
    gaps = {name: (train._leaf_gaps(got["grad1"], want["grad1"]),
                   train._leaf_gaps(got["delta"], want["delta"], moving))
            for name, got in sides.items()}
    out = {}
    for step in steps:
        again = reference([dict(s, batch=train._perturbed(s["batch"], step))
                           for s in base])
        rep = (train._leaf_gaps(again["grad1"], want["grad1"]),
               train._leaf_gaps(again["delta"], want["delta"], moving))
        for name, (g, c) in gaps.items():
            out.setdefault(name + "_steps", {})[repr(step)] = dict(
                grad_gap_ratio=g / max(rep[0], 1e-12),
                update_gap_ratio=c / max(rep[1], 1e-12),
                grad_gap=g, change_gap=c, grad_repeat=rep[0],
                change_repeat=rep[1])
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--all-rounds", action="store_true")
    p.add_argument("--repeat-steps", type=float, nargs="*", default=[])
    p.add_argument("--out")
    a = p.parse_args(argv)

    from benchmark import run as bench_run
    from benchmark.lib import loader

    for var, sub in bench_run.CACHE_DIRS.items():
        os.environ[var] = os.path.join(bench_run.CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)

    import torch

    if not torch.cuda.is_available():
        print("limit_readings: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    _, _, config, traffic, wl = loader.cell(loader.benchmark(), a.workload)
    if a.all_rounds:
        wl = dict(wl, sample=dict(wl["sample"], rounds=ALL_ROUNDS))
    runner = loader.runner(config["runner"])
    done = {}
    for seed in a.seeds:
        done[seed] = done.get(seed, 0) + 1
        ctx = bench_run.Context(a.workload, config, traffic, wl, seed,
                                a.seconds, False, False, dev,
                                time.perf_counter_ns())
        rec = runner.run(ctx)
        line = dict(seed=seed, repeat=done[seed], window_s=rec["window_s"],
                    attempted=rec["attempted"], failed=rec["failed"],
                    rounds_in_window=rec.get("window_rounds"))
        sides = [("program", False)]
        if seed in a.control_seeds and done[seed] == 1:
            sides.append(("control", True))
        if a.repeat_steps:
            t = time.perf_counter()
            line.update(repeat_readings(ctx, rec, a.repeat_steps,
                                        len(sides) > 1))
            line["check_s"] = time.perf_counter() - t
            sides = []
        for name, control in sides:
            ctx.control = control
            t = time.perf_counter()
            numbers, counts = runner.check(ctx, rec)
            line[name] = {n["name"]: n["value"] for n in numbers}
            line[name + "_s"] = time.perf_counter() - t
            line["counts"] = counts
        del rec
        torch.cuda.empty_cache()
        text = json.dumps(line)
        print(text, flush=True)
        if a.out:
            with open(a.out, "a") as f:
                f.write(text + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
