"""The import guard, the reference's independence from the program, and
the runs that must fail: no card, no program."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from conftest import ROOT

from perfbench.harness import guard

FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "anemoi_tpu"}


def imported_tops(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


def sources(folder: str):
    for base, _, files in os.walk(os.path.join(ROOT, folder)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(base, f)


def test_guard_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setattr(sys, "modules", {k: v for k, v in sys.modules.items()
                                         if k.split(".")[0] not in FORBIDDEN})
    sys.modules["anemoi_tpu_torch_lookalike"] = object()
    assert guard.loaded() == []
    guard.check("a test")
    sys.modules["jax.numpy"] = object()
    assert guard.loaded() == ["jax"]
    with pytest.raises(SystemExit) as err:
        guard.check("a test")
    assert err.value.code == 3


def test_no_benchmark_file_imports_jax_or_the_jax_package():
    for path in sources("perfbench"):
        assert not imported_tops(path) & FORBIDDEN, path


def test_reference_imports_nothing_of_the_program():
    for path in sources("perfbench/reference"):
        tops = imported_tops(path)
        assert "anemoi_tpu_torch" not in tops and not tops & FORBIDDEN, path


def test_a_run_loads_no_jax():
    code = ("import sys; sys.path.insert(0, %r); import perfbench.harness.loop, "
            "anemoi_tpu_torch.training.step, anemoi_tpu_torch.inference; "
            "from perfbench.harness import cell, guard; cell.driver('train'); "
            "cell.driver('forecast'); print(guard.loaded())" % ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


PLANTED = """import jax  # noqa: F401


def read(trace, ctx):
    return 1.0
"""


def test_a_reader_that_loads_jax_prints_no_result(tiny_bench, tmp_path):
    """A per-layer metric's reader that imports JAX, as a later PR could add:
    the run exits with 3 and prints no result (the look for a card skipped,
    the tiny configuration on the CPU)."""
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "perfbench"), root / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "perfbench" / "metrics" / "planted.forecast.py").write_text(PLANTED)
    workload = "transformer1024-forecast-b1"
    tiny_bench["per_layer"].append(
        {"name": "planted.forecast", "unit": "%", "better": "higher", "source": "device_trace",
         "layer": "device", "moves": "forecast_states_per_s", "workloads": [workload]})
    for c in tiny_bench["configs"]:
        c["file"] = os.path.join(ROOT, c["file"])
    (root / "BENCHMARK.json").write_text(json.dumps(tiny_bench))
    code = ("import sys, argparse, time, torch; sys.path[:0] = [%r, %r]; "
            "from perfbench.harness import cell; "
            "args = argparse.Namespace(workload=%r, seed=3, seconds=0.2, trace=1); "
            "sys.exit(cell.finish(cell.load_json(%r), args, torch.device('cpu'), "
            "time.perf_counter()))" % (str(root), ROOT, workload,
                                       str(root / "BENCHMARK.json")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=600, cwd=str(root))
    assert out.returncode == 3, out.stderr[-2000:]
    assert out.stdout == ""
    assert "import guard: jax" in out.stderr and "loaded at the result" in out.stderr


def command(cwd, *extra, env=None):
    return subprocess.run([sys.executable, "perfbench/run.py", "--workload", "gt1024-train-b4",
                           "--seed", "1", "--seconds", "1", "--trace", "0", *extra], cwd=cwd,
                          capture_output=True, text=True, timeout=300, env=env)


def test_run_fails_without_a_card():
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}
    out = command(ROOT, env=env)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA card" in out.stderr


def test_run_fails_with_only_the_benchmark(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "perfbench"), tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = command(str(tmp_path))
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.cuda
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    out = command(ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert '"correct": true' in out.stdout.splitlines()[-1]
