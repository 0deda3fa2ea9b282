"""One run of one cell: find the cell's files by name, run its driver, read
its metrics, print the result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell (an entry of ``workloads`` in ``BENCHMARK.json``) names a
configuration, whose file is ``configs[].file``, and a traffic mix, read
from ``perfbench/traffic/<traffic>.json`` and driven by the loop in
``perfbench/drivers/<driver>.py`` that its ``driver`` names
(``harness/loop.py``).  With ``--trace 0`` the result
holds the cell's end-to-end metrics; with ``--trace 1`` its per-layer
metrics, each read by ``perfbench/metrics/<metric>.py`` from the profiled
stretch.  The last line of standard output is the result; the compared
numbers with their limits are the last lines of standard error.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
from typing import Dict, Optional

import torch

from perfbench.harness import card, guard

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
BENCH = os.path.join(ROOT, "perfbench")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def find_cell(bench: dict, workload: str) -> dict:
    for cell in bench["workloads"]:
        if cell["name"] == workload:
            return cell
    raise SystemExit(f"no workload {workload} in BENCHMARK.json")


def cell_files(bench: dict, cell: dict) -> tuple:
    """The cell's configuration and traffic mix, from their files."""
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])
    return (load_json(os.path.join(ROOT, config["file"])),
            load_json(os.path.join(BENCH, "traffic", f"{cell['traffic']}.json")))


def end_to_end_names(bench: dict, workload: str) -> list:
    return [m["name"] for m in bench["end_to_end"]
            if workload in m.get("workloads", [workload])]


def per_layer_metrics(bench: dict, workload: str) -> list:
    """The per-layer metrics a cell reports: those that list it, and those
    without a list whose end-to-end metric the cell reports."""
    e2e = set(end_to_end_names(bench, workload))
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in e2e else [])]


def load_file(folder: str, name: str):
    """The module ``perfbench/<folder>/<name>.py``, loaded once."""
    key = f"perfbench_{folder}_{name}"
    if key not in sys.modules:
        path = os.path.join(BENCH, folder, f"{name}.py")
        if not os.path.isfile(path):
            raise SystemExit(f"no file {os.path.relpath(path, ROOT)}")
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def reader(metric: str):
    """The reader of a per-layer metric: ``perfbench/metrics/<metric>.py``."""
    return load_file("metrics", metric).read


def driver(name: str):
    """The loop a traffic mix names: ``perfbench/drivers/<name>.py``."""
    return load_file("drivers", name)


def run_cell(bench: dict, workload: str, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> dict:
    """Run one cell and return its result line as a dict."""
    from perfbench.harness.loop import Run

    cell = find_cell(bench, workload)
    config, traffic = cell_files(bench, cell)
    outcome = driver(traffic["driver"]).run(Run(config, traffic, seed, seconds, trace, device,
                                                t_start))
    guard.check("the end of the run")
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    metrics: Dict[str, dict] = {}
    if trace:
        for m in per_layer_metrics(bench, workload):
            value = reader(m["name"])(outcome.trace, outcome.ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for name in end_to_end_names(bench, workload):
            metrics[name] = {"value": outcome.e2e[name], "unit": units[name]}
    numbers_ok = all(math.isfinite(v) for v, _ in outcome.checks.values())
    correct = numbers_ok and all(v <= limit for v, limit in outcome.checks.values())
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(cell["chips"]), "memory_peak_bytes": int(outcome.memory_peak)}
    result = {"correct": bool(correct), "attempted": outcome.attempted,
              "failed": outcome.failed, "metrics": metrics, "device": dev}
    if trace:
        t = outcome.trace
        dev["busy_s"], dev["window_s"] = t.busy_s, t.window_s
        result["breakdown"] = {"device_ops": t.top_ops(), "idle_gaps": t.idle_gaps()}
    result["checks"] = {k: {"value": v, "limit": limit} for k, (v, limit) in
                        outcome.checks.items()}
    result["_notes"] = outcome.notes
    return result


def main(argv: Optional[list], t_start: float) -> int:
    ap = argparse.ArgumentParser(description="Run one cell of BENCHMARK.json once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench_path = os.path.join(ROOT, "BENCHMARK.json")
    if not os.path.isfile(bench_path):
        print("no BENCHMARK.json at the root of the checkout", file=sys.stderr)
        return 2
    bench = load_json(bench_path)
    cell = find_cell(bench, args.workload)
    chips = int(cell["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    if importlib.util.find_spec("anemoi_tpu_torch") is None:
        print("the program under test (anemoi_tpu_torch) is not in this checkout",
              file=sys.stderr)
        return 2
    print(f"card: {card.line()}", file=sys.stderr)
    return finish(bench, args, torch.device("cuda", 0), t_start)


def finish(bench: dict, args: argparse.Namespace, device: torch.device, t_start: float) -> int:
    """Run the cell on ``device`` and print the result, once the import
    guard has passed after every reader."""
    torch.set_num_threads(1)  # the host's part is one thread dispatching to the card
    result = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                      device, t_start)
    guard.check("the result")
    notes = result.pop("_notes")
    print("notes: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                for k, v in notes.items()), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
