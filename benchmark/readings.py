"""Read a cell's compared numbers for the program and for its control on
many seeds, in one process on the CUDA card: the readings a limit is set
from (PERF.md).  Each seed makes one run of the cell (set-up, a window of
`--seconds`, the program freed) and checks it twice, once as the
benchmark does and once with the control (the reference in the precision
below the configuration's) in the program's place.

    python3 benchmark/readings.py --workload <cell> --seeds <n> [<n> ...] \\
        --seconds <s> [--out <file.jsonl>]

Prints one JSON line a seed: its numbers under `program` and `control`,
with the run's window, frames or passes, and rounds seen.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--out")
    a = p.parse_args(argv)

    from benchmark import run as bench_run
    from benchmark.lib import loader

    for var, sub in bench_run.CACHE_DIRS.items():
        os.environ[var] = os.path.join(bench_run.CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)

    import torch

    if not torch.cuda.is_available():
        print("readings: no CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    bench = loader.benchmark()
    _, _, config, traffic, wl = loader.cell(bench, a.workload)
    runner = loader.runner(config["runner"])
    for seed in a.seeds:
        ctx = bench_run.Context(a.workload, config, traffic, wl, seed,
                                a.seconds, False, False, dev,
                                time.perf_counter_ns())
        rec = runner.run(ctx)
        line = dict(seed=seed, window_s=rec["window_s"],
                    attempted=rec["attempted"], failed=rec["failed"],
                    rounds_in_window=rec.get("window_rounds"))
        for name, control in (("program", False), ("control", True)):
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
