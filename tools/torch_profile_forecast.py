"""Where a forecast step, or a training step, of the PyTorch port spends its
time on the card.

    python3 tools/torch_profile_forecast.py [--steps 2] [--reps 3] [--json PATH]
    python3 tools/torch_profile_forecast.py --train [--reps 3] [--json PATH]

Builds the full-width flagship (o96 -> ico-5, 512 channels, 16 layers, 16
heads, seeded random weights) with ``anemoi_tpu_torch``, warms up, then
traces with ``torch.profiler`` either ``reps`` forecasts of ``steps`` steps
(bf16 serving) or, with ``--train``, ``reps`` training steps of
``make_step_fns`` (bf16 compute over float32 masters, area-weighted MSE,
AdamW, value clipping at 32, rollout 1).  Prints the card (name, power
limit), the wall ms per step, the device-busy share of the traced window,
and the device time by kernel name (top 20); with --json also writes them
to PATH.  Needs a CUDA card.
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
    ap.add_argument("--train", action="store_true", help="profile training steps")
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
        statistics=flagship_statistics(0), device=device, training=args.train,
    )
    gen = torch.Generator(device=device).manual_seed(0)
    steps = 1 if args.train else args.steps
    batch = {"data": torch.randn(1, 2 + steps, 1, graph["data"].num_nodes, 7,
                                 generator=gen, device=device)}
    if args.train:
        from anemoi_tpu_torch.training.losses import get_loss_function
        from anemoi_tpu_torch.training.losses.scalers import create_scalers
        from anemoi_tpu_torch.training.optimizers import build_optimizer
        from anemoi_tpu_torch.training.step import TrainState, make_step_fns

        scalers = create_scalers({"area": {"name": "GraphNodeAttributeScaler",
                                           "nodes_name": "data", "attribute_name": "area_weight"}},
                                 graph=graph)
        losses = {"data": get_loss_function({"name": "WeightedMSELoss", "scalers": ["area"]},
                                            scalers)}
        state = TrainState.create(iface, build_optimizer(
            {"lr": {"rate": 1e-4, "warmup": 10, "iterations": 1000},
             "gradient_clip": {"val": 32.0, "algorithm": "value"}}))
        train_step, _ = make_step_fns(iface, losses, rollout=1, precision="bf16")

        def run():
            train_step(state, batch)
    else:
        forecast = make_forecast_fn(iface, steps=steps)

        def run():
            forecast(batch)
    for _ in range(3):
        run()
    torch.cuda.synchronize()

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(args.reps):
            run()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3

    kernels = {}
    for evt in prof.events():
        # device events other than kernels' (user annotations such as
        # "Optimizer.step#AdamW.step" span kernels already counted) are skipped
        if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(
            evt, "is_user_annotation", False
        ):
            kernels.setdefault(evt.name, [0.0, 0])
            kernels[evt.name][0] += evt.device_time / 1e3  # us -> ms
            kernels[evt.name][1] += 1
    device_ms = sum(v[0] for v in kernels.values())
    n_steps = args.reps * steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:20]
    result = {
        "card": card,
        "mode": "training step" if args.train else "forecast step",
        "kernel_launches_per_step": sum(v[1] for v in kernels.values()) / n_steps,
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
