"""Where the port's trainer spends a training step on the card.

    python3 tools/torch_profile_trainer.py [--steps 8] [--rounds 2] [--json PATH]

Builds the packaged example (``example_o96_gt_config``: o96 -> ico-5
``multi_scale`` graph, 512 channels, 16 layers, bf16) as an
``AnemoiTrainer`` reading a zlib zarr store of its synthetic dataset, written
first into a temporary directory, and times in turns (``rounds`` times,
in the order fixed, prefetch 2, prefetch 0, then reversed) ``steps``
training steps of its ``train_step``, each followed by the ``.item()`` of
its loss and grad norm as the trainer does at ``log_interval=1``:

- ``fixed``: one batch kept on the card (the data pipeline left out);
- ``prefetch2``: batches from ``DataModule.train_batches`` through the
  prefetch thread two ahead (the trainer's default);
- ``prefetch0``: the same batches read, decoded and copied inline.

Prints the card (name, power limit), each variant's median and spread of
wall ms a step (after the first two steps of each run) and host ms waiting
for a batch; then ``torch.profiler`` over ``steps`` steps of the fixed and
the prefetch-2 loops: device-busy share, device ms a step, launches a step
and the top kernels.  With --json also writes everything to PATH.  Needs a
CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import torch


def loop(trainer, train_step, batches, steps: int):
    """(wall ms a step, host ms waiting for each batch) of ``steps`` steps."""
    walls, waits = [], []
    it = iter(batches)
    for _ in range(steps):
        t0 = time.perf_counter()
        batch = next(it)
        t1 = time.perf_counter()
        _, metrics = train_step(trainer.state, batch)
        float(metrics["loss"]), float(metrics["grad_norm"])
        walls.append((time.perf_counter() - t0) * 1e3)
        waits.append((t1 - t0) * 1e3)
    if hasattr(it, "close"):
        it.close()
    return walls, waits


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    from anemoi_tpu_torch.data.dataset import open_dataset, save_zarr_copy
    from anemoi_tpu_torch.data.prefetch import maybe_prefetch
    from anemoi_tpu_torch.flagship import example_o96_gt_config
    from anemoi_tpu_torch.training.trainer import AnemoiTrainer

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    print(f"[card] {card}", flush=True)
    out = {"card": card, "steps": args.steps, "variants": {}}
    with tempfile.TemporaryDirectory(prefix="profile_trainer_") as workdir:
        config = example_o96_gt_config()
        store = os.path.join(workdir, "example_o96.zarr")
        t0 = time.perf_counter()
        save_zarr_copy(open_dataset(dict(config["data"]["datasets"]["data"])), store)
        out["store_write_s"] = time.perf_counter() - t0
        config["data"]["datasets"]["data"] = {"kind": "zarr", "path": store}
        config["output_dir"] = os.path.join(workdir, "run")
        t0 = time.perf_counter()
        trainer = AnemoiTrainer(config)
        out["trainer_init_s"] = time.perf_counter() - t0
        train_step, _ = trainer._get_step_fns(1)
        dm = trainer.datamodule
        fixed = trainer.put_batch(next(iter(dm.train_batches(0))))

        def run(name, epoch):
            if name == "fixed":
                return loop(trainer, train_step, iter(lambda: fixed, None), args.steps + 2)
            size = 2 if name == "prefetch2" else 0
            return loop(trainer, train_step,
                        maybe_prefetch(dm.train_batches(epoch), trainer._put, size),
                        args.steps + 2)

        order = ["fixed", "prefetch2", "prefetch0"]
        epoch = 0
        for rnd in range(args.rounds):
            for name in order if rnd % 2 == 0 else order[::-1]:
                walls, waits = run(name, epoch)
                epoch += 1
                v = out["variants"].setdefault(name, {"walls": [], "waits": []})
                v["walls"] += walls[2:]
                v["waits"] += waits[2:]
        for name, v in out["variants"].items():
            v["median_ms"] = statistics.median(v["walls"])
            v["min_ms"], v["max_ms"] = min(v["walls"]), max(v["walls"])
            v["wait_median_ms"] = statistics.median(v["waits"])
            print(f"[{name}] wall ms a step median {v['median_ms']:.3f} (min {v['min_ms']:.3f}, "
                  f"max {v['max_ms']:.3f}); host wait for a batch median "
                  f"{v['wait_median_ms']:.3f} ms", flush=True)

        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]

        for name in ("fixed", "prefetch2"):
            run(name, epoch)  # warm the variant
            epoch += 1
            torch.cuda.synchronize()
            with profile(activities=acts) as prof:
                t0 = time.perf_counter()
                walls, _ = run(name, epoch)
                torch.cuda.synchronize()
                wall_s = time.perf_counter() - t0
            epoch += 1
            kernels = {}
            for evt in prof.events():
                # device events other than kernels' and copies (user
                # annotations span kernels already counted) are skipped
                if evt.device_type == torch.autograd.DeviceType.CUDA and not getattr(
                        evt, "is_user_annotation", False):
                    kernels.setdefault(evt.name, [0.0, 0])
                    kernels[evt.name][0] += evt.device_time / 1e3  # us -> ms
                    kernels[evt.name][1] += 1
            n = args.steps + 2
            device_ms = sum(v[0] for v in kernels.values())
            top = sorted(kernels.items(), key=lambda kv: -kv[1][0])[:12]
            prof_out = {
                "device_ms_per_step": device_ms / n,
                "launches_per_step": sum(v[1] for v in kernels.values()) / n,
                "busy_share": device_ms / (wall_s * 1e3), "wall_ms_per_step": wall_s * 1e3 / n,
                "top": [(key[:90], ms / n) for key, (ms, _) in top],
            }
            out["variants"][name]["profile"] = prof_out
            print(f"[{name} profile] device {prof_out['device_ms_per_step']:.3f} ms a step, "
                  f"{prof_out['launches_per_step']:.1f} launches a step, busy "
                  f"{prof_out['busy_share']:.3f} of {prof_out['wall_ms_per_step']:.3f} ms",
                  flush=True)
            for key, ms in prof_out["top"]:
                print(f"    {ms:8.3f} ms  {key}", flush=True)
    print(card)
    if args.json:
        os.makedirs(os.path.dirname(os.path.abspath(args.json)), exist_ok=True)
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
