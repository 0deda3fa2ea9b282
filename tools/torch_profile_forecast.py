"""Where a forecast step of the PyTorch port spends its time on the card.

    python3 tools/torch_profile_forecast.py [--steps 2] [--reps 3] [--json PATH]

Builds the full-width flagship (o96 -> ico-5, 512 channels, 16 layers, 16
heads, bf16 serving, seeded random weights) with ``anemoi_tpu_torch``, warms
up, then traces ``reps`` forecasts of ``steps`` steps with
``torch.profiler``.  Prints the card (name, power limit), the wall ms per
step, the device-busy share of the traced window, and the device time by
kernel name (top 15); with --json also writes them to PATH.
Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from anemoi_tpu_torch.flagship import (
        flagship_config, flagship_indices, flagship_recipe, flagship_statistics,
    )
    from anemoi_tpu_torch.graphs.create import GraphCreator
    from anemoi_tpu_torch.inference import make_forecast_fn
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    device = torch.device("cuda")
    graph = GraphCreator(flagship_recipe("o96", 5)).create()
    torch.manual_seed(0)
    iface = AnemoiModelInterface(
        config=flagship_config(), graph=graph, data_indices=flagship_indices(),
        statistics=flagship_statistics(0), device=device,
    )
    gen = torch.Generator(device=device).manual_seed(0)
    batch = {"data": torch.randn(1, 2 + args.steps, 1, graph["data"].num_nodes, 7,
                                 generator=gen, device=device)}
    forecast = make_forecast_fn(iface, steps=args.steps)
    for _ in range(3):
        forecast(batch)
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            forecast(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            kernels.setdefault(evt.name, [0.0, 0])
            kernels[evt.name][0] += evt.device_time / 1e3  # us -> ms
            kernels[evt.name][1] += 1
    device_ms = sum(v[0] for v in kernels.values())
    n_steps = args.reps * args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:15]
    result = {
        "card": card,
        "wall_ms_per_step": wall_ms / n_steps,
        "device_kernel_ms_per_step": device_ms / n_steps,
        "device_busy_share": device_ms / wall_ms,
        "top_kernels": [
            {"name": name[:120], "ms_per_step": ms / n_steps, "calls_per_step": calls / n_steps,
             "share_of_device_time": ms / device_ms}
            for name, (ms, calls) in top
        ],
    }
    print(card)
    print(json.dumps(result, indent=1))
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(result, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
