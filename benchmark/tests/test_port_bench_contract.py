"""BENCHMARK.json keeps the benchmark's contract: its keys, names,
units and limits, and the files the harness finds by those names."""

import json
import os
import re

import pytest

from benchmark.lib import loader

BENCH = loader.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
E2E_KEYS = {"name", "unit", "better", "bound", "source"}
LAYER_KEYS = {"name", "unit", "better", "source", "layer", "moves"}


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_size():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    path = os.path.join(loader.ROOT, "BENCHMARK.json")
    assert os.path.getsize(path) <= 64 * 1024


def test_command_and_paths():
    cmd, paths = BENCH["command"], BENCH["paths"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.rstrip("/").endswith("_torch")
    for w in cmd[1:]:
        if "/" in w or w.endswith(".py"):
            assert any(w.startswith(p.rstrip("/") + "/") for p in paths)
            assert os.path.exists(os.path.join(loader.ROOT, w))


def test_run_seconds_fits_the_check_with_every_cell():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    runs = 2 + 14 * cells
    assert runs * (s + 60) + cells * 2 * 90 + 1200 <= 43200


def test_names_are_unique_and_well_formed():
    groups = [BENCH["configs"], BENCH["workloads"],
              BENCH["end_to_end"] + BENCH["per_layer"]]
    for group in groups:
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names), names
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


@pytest.mark.parametrize("conf", BENCH["configs"], ids=lambda c: c["name"])
def test_configs(conf):
    assert set(conf) == {"name", "source", "file", "reduced", "why"}
    assert _line(conf["source"]) and conf["source"].startswith("https://")
    assert _line(conf["why"])
    assert len(conf["reduced"]) <= 16
    assert all(NAME.match(k) for k in conf["reduced"])
    assert any(conf["file"].startswith(p + "/") for p in BENCH["paths"])
    data = loader.load_json(os.path.join(loader.ROOT, conf["file"]))
    assert data["name"] == conf["name"]
    assert data["reduced"] == conf["reduced"]
    assert any(w["config"] == conf["name"] for w in BENCH["workloads"])
    for k in conf["reduced"]:
        assert not re.search(r"(_dim|_rank|hidden|width|expert)", k)
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cells(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert cell["chips"] in (1, 4) and _line(cell["why"])
    assert any(c["name"] == cell["config"] for c in BENCH["configs"])
    loader.cell(BENCH, cell["name"])            # its files exist
    e2e = loader.metrics_of(BENCH, cell["name"], False)
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert loader.metrics_of(BENCH, cell["name"], True)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert pairs.count((cell["config"], cell["traffic"])) == 1


def test_four_chip_cells_are_few():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


@pytest.mark.parametrize("m", BENCH["end_to_end"], ids=lambda m: m["name"])
def test_end_to_end_metrics(m):
    assert set(m) - {"workloads"} == E2E_KEYS
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("host_clock", "device_trace")
    assert 0.01 <= m["bound"] <= 0.25
    assert os.path.exists(os.path.join(loader.HERE, "metrics",
                                       m["name"] + ".py"))
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m.get("workloads", cells)) <= cells


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metrics(m):
    assert set(m) - {"workloads"} == LAYER_KEYS
    assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert m["source"] in ("device_trace", "program_span", "program_counter",
                           "host_clock")
    assert _line(m["layer"])
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    cells = set(e2e[m["moves"]].get("workloads",
                                    [w["name"] for w in BENCH["workloads"]]))
    assert set(m.get("workloads", cells)) <= cells
    assert os.path.exists(os.path.join(loader.HERE, "metrics",
                                       m["name"] + ".py"))
    if m["name"].endswith("_roofline") or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_every_file_under_paths_is_named_from_name_characters():
    for p in BENCH["paths"]:
        for dirpath, dirs, files in os.walk(os.path.join(loader.ROOT, p)):
            dirs[:] = [d for d in dirs if d != "__pycache__"]
            for f in files:
                rel = os.path.relpath(os.path.join(dirpath, f), loader.ROOT)
                assert PATH.match(rel), rel


def test_the_json_is_plain():
    with open(os.path.join(loader.ROOT, "BENCHMARK.json")) as f:
        assert json.load(f) == BENCH
