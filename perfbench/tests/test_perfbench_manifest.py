"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of the harness."""

from __future__ import annotations

import importlib
import importlib.util
import math
import os
import re

from conftest import ROOT, load

from perfbench.harness import cell as harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}
WIDTH_WORDS = ("hidden", "intermediate", "latent", "state", "projection", "head", "channels",
               "expansion", "experts_per")


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"] == ["python3", "perfbench/run.py"]
    assert bench["paths"] == ["perfbench"]
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024


def test_names_units_and_keys(bench):
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[part]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and "\n" not in m["layer"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_what_it_must(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    pairs = set()
    for w in bench["workloads"]:
        pairs.add((w["config"], w["traffic"]))
        names = harness.end_to_end_names(bench, w["name"])
        assert "setup_s" in names and len(names) >= 2, w["name"]
        layer = harness.per_layer_metrics(bench, w["name"])
        assert layer, w["name"]
        for m in layer:
            assert m["moves"] in names, (w["name"], m["name"])
    assert len(pairs) == len(bench["workloads"])
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, math.floor(0.25 * len(bench["workloads"])))


def test_each_name_finds_its_files(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        cfg = load(c["file"])
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert not any(word in key for word in WIDTH_WORDS) and not key.endswith(
                ("_dim", "_rank")), key
        assert set(cfg["limits"]) == {"train", "forecast"}
        assert os.path.isfile(os.path.join(ROOT, cfg["reference"]))
    for w in bench["workloads"]:
        config, traffic = harness.cell_files(bench, w)
        assert os.path.isfile(os.path.join(ROOT, "perfbench", "drivers",
                                           f"{traffic['driver']}.py"))
        module = harness.driver(traffic["driver"])
        assert callable(module.run) and callable(module.calibrate)
        ref = importlib.import_module(config["reference"][:-3].replace("/", "."))
        assert all(callable(getattr(ref, f)) for f in ("parameter_shapes", "graph_tensors",
                                                       "model_shape", "edge_dim"))
    for m in bench["per_layer"]:
        path = os.path.join(ROOT, "perfbench", "metrics", f"{m['name']}.py")
        assert os.path.isfile(path), m["name"]
        assert callable(harness.reader(m["name"]))


def test_end_to_end_metrics_come_from_the_drivers(bench):
    for w in bench["workloads"]:
        _, traffic = harness.cell_files(bench, w)
        produced = set(harness.driver(traffic["driver"]).END_TO_END)
        assert set(harness.end_to_end_names(bench, w["name"])) <= produced


def test_no_file_outside_the_paths_is_named(bench):
    for word in bench["command"][1:]:
        assert word.startswith("perfbench/") and ".." not in word
    spec = importlib.util.find_spec("perfbench")
    assert spec is not None
