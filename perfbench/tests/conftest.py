"""Shared helpers of the benchmark's own tests (``python -m pytest
perfbench/tests``).  The tiny configurations under ``tests/configs`` are
the cells' configurations cut to the CPU (o16 -> ico-2, 32 channels, 2
layers, 4 heads); each test run takes the limits of the full
configuration it stands for."""

from __future__ import annotations

import json
import os
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

TINY = {"gt-o96-1024": "tiny-gt", "transformer-o96-1024": "tiny-transformer"}


def load(path: str) -> dict:
    with open(os.path.join(ROOT, path)) as f:
        return json.load(f)


@pytest.fixture(autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def bench():
    return load("BENCHMARK.json")


@pytest.fixture
def tiny_bench(tmp_path):
    """BENCHMARK.json with each configuration replaced by its tiny copy,
    which keeps the full configuration's limits."""
    b = load("BENCHMARK.json")
    for c in b["configs"]:
        full = load(c["file"])
        tiny = load(f"perfbench/tests/configs/{TINY[c['name']]}.json")
        tiny["limits"] = full["limits"]
        path = tmp_path / f"{c['name']}.json"
        path.write_text(json.dumps(tiny))
        c["file"] = os.path.relpath(path, ROOT)
    return b


def tiny_config(name: str) -> dict:
    tiny = load(f"perfbench/tests/configs/{TINY[name]}.json")
    tiny["limits"] = load(f"perfbench/configs/{name}.json")["limits"]
    return tiny
