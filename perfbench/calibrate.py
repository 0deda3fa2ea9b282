"""The readings the limits of ``correct`` are set from, at a cell's own
size, on several seeds in one process:

    python3 perfbench/calibrate.py --workload <name> --seeds 1,2,3 [--program] [--control] [--faults]

``--program``: a short run of the cell on each seed (``--seconds``, default
2), printing the numbers the run compares with their limits.  ``--faults``
(training cells): the float32 reference trained on half of each batch, the
mean taken over the rest, put in the program's place.  ``--control``:
the reference computed a step lower than the configuration states (float8
e4m3 operands in every matrix product, against the program's bf16) put in
the program's place, compared with the float32 reference as the run
compares the program.  One JSON line a seed and kind.  Needs a CUDA card.
The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

from perfbench.harness.cell import (  # noqa: E402
    cell_files,
    driver,
    find_cell,
    load_json,
    run_cell,
)


def control_numbers(config: dict, traffic: dict, seed: int, device, half_batch=False) -> dict:
    """The control's compared numbers on one seed (the driver's checks, with
    the control in the program's place); with ``half_batch``, those of the
    float32 reference that leaves out half of each batch."""
    from perfbench.harness.inputs import build_inputs

    kind = "half_batch" if half_batch else "control"
    return driver(traffic["driver"]).calibrate(build_inputs(config, seed), traffic, seed,
                                               device, kind)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--program", action="store_true")
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--faults", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    bench = load_json(os.path.join(ROOT, "BENCHMARK.json"))
    config, traffic = cell_files(bench, find_cell(bench, args.workload))
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.program:
            t0 = time.perf_counter()
            result = run_cell(bench, args.workload, seed, args.seconds, False, device, t0)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": "program",
                              "correct": result["correct"],
                              "numbers": {k: c["value"] for k, c in result["checks"].items()},
                              "notes": result["_notes"]}), flush=True)
            torch.cuda.empty_cache()
        if args.control:
            t0 = time.perf_counter()
            numbers = control_numbers(config, traffic, seed, device)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": "control",
                              "numbers": numbers, "seconds": time.perf_counter() - t0}),
                  flush=True)
            torch.cuda.empty_cache()
        if args.faults and traffic["driver"] == "train":
            t0 = time.perf_counter()
            numbers = control_numbers(config, traffic, seed, device, half_batch=True)
            print(json.dumps({"workload": args.workload, "seed": seed, "kind": "half_batch",
                              "numbers": numbers, "seconds": time.perf_counter() - t0}),
                  flush=True)
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
