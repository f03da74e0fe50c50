"""Run one cell of BENCHMARK.json once on the CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

The last line of standard output is one JSON object: `correct`,
`attempted`, `failed`, `metrics` (the cell's end-to-end metrics, or with
`--trace 1` its per-layer metrics), `device`, with `--trace 1` a
`breakdown` of the device trace, and last `checks`, each number the
correctness check compared with its limit (also the last lines of
standard error).  `--control 1` puts the reference in the precision
below the configuration's in the program's place in the check: its
numbers are the control's readings.  Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits with 2; if
a module of JAX or of the JAX package was loaded, with 3.
"""

import time

T0_NS = time.perf_counter_ns()

import argparse                                          # noqa: E402
import dataclasses                                       # noqa: E402
import json                                              # noqa: E402
import os                                                # noqa: E402
import sys                                               # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

# every cache the program or PyTorch may write, at fixed paths inside the
# checkout, so that only the first run of a checkout builds anything
CACHE = os.path.join(ROOT, ".bench_cache")
CACHE_DIRS = dict(TRITON_CACHE_DIR="triton", TORCH_EXTENSIONS_DIR="torch_ext",
                  CUDA_CACHE_PATH="nv")


@dataclasses.dataclass
class Context:
    """What a runner gets: the cell's files, the run's arguments, the
    device, and the start of set-up on the host clock."""
    workload_name: str
    config: dict
    traffic: dict
    workload: dict
    seed: int
    seconds: float
    trace: bool
    control: bool
    device: object
    t0_ns: int

    def log(self, msg):
        print(msg, file=sys.stderr, flush=True)


def run_cell(workload, seed, seconds, trace, device, control=False,
             t0_ns=None, bench=None, override=None):
    """Run a cell; returns (result dict, compared numbers, info dict).
    `override` (tests only) updates parts of the cell's files."""
    from benchmark.lib import guard, loader

    bench = bench or loader.benchmark()
    cell, _, config, traffic, wl = loader.cell(bench, workload)
    for part, new in (override or {}).items():
        {"config": config, "traffic": traffic, "workload": wl}[part].update(
            new)
    runner = loader.runner(config["runner"])
    ctx = Context(workload, config, traffic, wl, seed, seconds, bool(trace),
                  bool(control), device,
                  time.perf_counter_ns() if t0_ns is None else t0_ns)
    rec = runner.run(ctx)
    t_check = time.perf_counter()
    numbers, counts = runner.check(ctx, rec)
    rec["check_s"] = time.perf_counter() - t_check
    found = guard.forbidden_modules()
    if found:
        raise ForbiddenModules(found)

    metrics = {}
    for m in loader.metrics_of(bench, workload, ctx.trace):
        value = loader.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = dict(value=value, unit=m["unit"])
    ok = (rec["failed"] == 0 and all(counts.values())
          and all(n["limit"] is not None and n["value"] <= n["limit"]
                  for n in numbers))
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": _device_name(device), "count": cell["chips"],
           "memory_peak_bytes": rec["memory_peak_bytes"]}
    result = dict(correct=bool(ok), attempted=rec["attempted"],
                  failed=rec["failed"], metrics=metrics, device=dev)
    if ctx.trace:
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = rec["trace"]["breakdown"]
    result["checks"] = {n["name"]: dict(value=n["value"], limit=n["limit"])
                        for n in numbers}
    info = {k: rec[k] for k in ("setup_s", "window_s", "keyframes", "steps",
                                "passes", "frames_left", "lookup_launches", "check_s",
                                "trace_read_s")
            if k in rec}
    info["samples_checked"] = counts
    if "latency_ms" in rec and rec["latency_ms"]:
        from benchmark.lib.stats import percentile
        info["frame_latency_median_ms"] = percentile(rec["latency_ms"], 50)
        info["frame_latency_count"] = len(rec["latency_ms"])
    if ctx.trace:
        info["launches"] = rec["trace"]["launches"]
    return result, numbers, info


class ForbiddenModules(RuntimeError):
    pass


def _device_name(device):
    import torch

    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    if args.seed < 0:
        p.error("--seed must be a non-negative integer")

    from benchmark.lib import loader

    cell = loader.cell(loader.benchmark(), args.workload)[0]
    for var, sub in CACHE_DIRS.items():
        os.environ[var] = os.path.join(CACHE, sub)
        os.makedirs(os.environ[var], exist_ok=True)

    import torch

    if not torch.cuda.is_available():
        print("benchmark: no CUDA device; the benchmark runs only on the "
              "card", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    try:
        result, numbers, info = run_cell(
            args.workload, args.seed, args.seconds, args.trace,
            torch.device("cuda", 0), control=args.control, t0_ns=T0_NS)
    except ForbiddenModules as e:
        print(f"benchmark: forbidden modules loaded: {', '.join(e.args[0])}",
              file=sys.stderr)
        return 3
    print(json.dumps({"info": info}), flush=True)
    for n in numbers:
        print(f"check {n['name']} {n['value']!r} limit {n['limit']!r}",
              file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
