"""Find a cell's pieces by the names BENCHMARK.json gives them."""

import importlib
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    """Import the Python file at `path` (a name may hold dots) as a module
    called `name`."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def benchmark():
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(bench, workload):
    """(cell entry, configuration entry, configuration file, traffic file,
    workload file) of the cell named `workload`."""
    for w in bench["workloads"]:
        if w["name"] == workload:
            break
    else:
        raise KeyError(f"no workload named {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == w["config"])
    return (w, conf, load_json(os.path.join(ROOT, conf["file"])),
            load_json(os.path.join(HERE, "traffic", w["traffic"] + ".json")),
            load_json(os.path.join(HERE, "workloads", workload + ".json")))


def metrics_of(bench, workload, traced):
    """The metric entries a run of `workload` reports: the end-to-end
    metrics untraced, the per-layer ones traced.  A metric without a
    `workloads` key belongs to every cell that reports the end-to-end
    metric it moves (or, end to end, to every cell)."""
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not traced:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload])
            and m["moves"] in names]


def reader(name):
    """The reader of metric `name`: benchmark/metrics/<name>.py's `read`."""
    return load_module(os.path.join(HERE, "metrics", name + ".py"),
                       "metric_" + name.replace(".", "_")).read


def runner(name):
    """benchmark/runners/<name>.py: runs one kind of cell."""
    return importlib.import_module("benchmark.runners." + name)


def generator(name):
    """benchmark/generators/<name>.py: makes one kind of traffic."""
    return importlib.import_module("benchmark.generators." + name)
