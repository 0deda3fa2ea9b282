"""Training profiler.

Port of ``anemoi_tpu.training.profiler``: :class:`BenchmarkProfiler` times
named sections and training steps of a short run and writes the speed,
time, memory and system reports as one JSON file
(``<output_dir>/profile/profiler_report.json``), optionally beside a
``torch.profiler`` trace (``trace/trace.json``, Chrome trace format, the
CPU and, on the card, the CUDA activity) where the JAX package writes a
``jax.profiler`` trace.

A section or step that times device work ends at a
``torch.cuda.synchronize()`` on the card (the JAX profiler's
``jax.block_until_ready``).  The memory report reads the card's allocator
(``torch.cuda.memory_allocated``, ``max_memory_allocated``,
``memory_reserved``) and its total memory; a device query that fails
raises, so that a report never comes back quietly without the card.  The
system report names the card (``torch.cuda.get_device_name``) and its power
limit (``nvidia-smi``).  On the CPU the memory report holds the host's
figures only, as the JAX profiler's does on a CPU backend.

``profile_training(trainer, num_steps, trace)`` runs ``num_steps`` training
steps of an ``AnemoiTrainer`` at its first rollout outside its loop (``cli
profile``).
"""

from __future__ import annotations

import contextlib
import json
import os
import platform
import subprocess
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from anemoi_tpu_torch.utils.tracing import span


def power_limit(index: int = 0) -> Optional[str]:
    """The card's power limit as ``nvidia-smi`` reports it, or None where
    there is no ``nvidia-smi``."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--id={index}", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True, timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip() or None


class BenchmarkProfiler:
    """Times train and validation steps and named sections, and collects
    device and host memory statistics."""

    def __init__(self, output_dir: str, trace: bool = False,
                 device: torch.device | str = "cpu") -> None:
        self.output_dir = output_dir
        os.makedirs(output_dir, exist_ok=True)
        self.trace = trace
        self.device = torch.device(device)
        self.step_times: list = []
        self.val_times: list = []
        self.section_times: Dict[str, list] = {}
        self._t0: Optional[float] = None
        self._profile = None
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)

    def sync(self) -> None:
        """Wait for the device's queued work."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # -- timing hooks ---------------------------------------------------
    def start_step(self) -> None:
        self._t0 = time.perf_counter()

    def end_step(self, validation: bool = False) -> None:
        if self._t0 is None:
            return
        self.sync()
        dt = time.perf_counter() - self._t0
        (self.val_times if validation else self.step_times).append(dt)
        self._t0 = None

    @contextlib.contextmanager
    def section(self, name: str, device: bool = False):
        """Accumulate the wall time of a named phase: ``with
        prof.section("dataloader"): ...``; with ``device`` the section ends
        when the device's work is done.  In a trace the section is the span
        ``anemoi.profile.<name>`` (``utils/tracing.py``)."""
        t0 = time.perf_counter()
        try:
            with span(f"anemoi.profile.{name}"):
                yield
                if device:
                    self.sync()
        finally:
            self.section_times.setdefault(name, []).append(time.perf_counter() - t0)

    # -- reports --------------------------------------------------------
    def time_report(self) -> Dict[str, Any]:
        """Per section: total, mean, count and share of the total."""
        out: Dict[str, Any] = {}
        for name, times in self.section_times.items():
            arr = np.asarray(times)
            out[name] = {"total_s": float(arr.sum()), "mean_s": float(arr.mean()),
                         "count": int(len(arr))}
        total = sum(v["total_s"] for v in out.values())
        for v in out.values():
            v["pct"] = round(100.0 * v["total_s"] / total, 1) if total else 0.0
        return out

    def speed_report(self, samples_per_step: int = 1, grid_points: int = 0) -> Dict[str, Any]:
        times = np.asarray(self.step_times[1:] or self.step_times)  # the first step warms up
        if len(times) == 0:
            return {}
        report = {
            "training_avg_throughput": float(1.0 / times.mean()),
            "training_avg_throughput_per_sample": float(samples_per_step / times.mean()),
            "avg_time_per_batch_s": float(times.mean()),
            "p50_time_per_batch_s": float(np.percentile(times, 50)),
            "p95_time_per_batch_s": float(np.percentile(times, 95)),
            "num_steps": int(len(times)),
        }
        if grid_points:
            report["grid_points_per_s"] = float(grid_points * samples_per_step / times.mean())
        if self.val_times:
            report["validation_avg_throughput"] = float(1.0 / np.asarray(self.val_times).mean())
        return report

    def memory_report(self) -> Dict[str, Any]:
        report: Dict[str, Any] = {}
        if self.device.type == "cuda":
            index = self.device.index if self.device.index is not None else \
                torch.cuda.current_device()
            report[f"cuda:{index}"] = {
                "name": torch.cuda.get_device_name(index),
                "bytes_in_use": int(torch.cuda.memory_allocated(index)),
                "peak_bytes_in_use": int(torch.cuda.max_memory_allocated(index)),
                "bytes_reserved": int(torch.cuda.memory_reserved(index)),
                "bytes_limit": int(torch.cuda.get_device_properties(index).total_memory),
            }
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith(("VmRSS", "VmHWM")):
                        key, val = line.split(":", 1)
                        report[f"host_{key.lower()}_kb"] = int(val.strip().split()[0])
        except OSError:
            pass
        return report

    def system_report(self) -> Dict[str, Any]:
        report = {
            "platform": platform.platform(),
            "python": platform.python_version(),
            "torch": torch.__version__,
            "devices": [str(self.device)],
            "cpu_count": os.cpu_count(),
        }
        if self.device.type == "cuda":
            index = self.device.index if self.device.index is not None else \
                torch.cuda.current_device()
            report["devices"] = [torch.cuda.get_device_name(i)
                                 for i in range(torch.cuda.device_count())]
            report["device_name"] = torch.cuda.get_device_name(index)
            report["power_limit"] = power_limit(index)
            report["cuda"] = torch.version.cuda
        return report

    def write_reports(self, extra: Optional[Dict] = None) -> str:
        reports = {
            "speed": self.speed_report(),
            "time": self.time_report(),
            "memory": self.memory_report(),
            "system": self.system_report(),
        }
        if extra:
            reports.update(extra)
        path = os.path.join(self.output_dir, "profiler_report.json")
        with open(path, "w") as f:
            json.dump(reports, f, indent=1, default=str)
        return path

    # -- trace ----------------------------------------------------------
    def trace_path(self) -> str:
        return os.path.join(self.output_dir, "trace", "trace.json")

    def __enter__(self):
        if self.trace:
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self.device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            self._profile = torch.profiler.profile(activities=activities)
            self._profile.__enter__()
        return self

    def __exit__(self, *exc):
        if self._profile is not None:
            self.sync()
            self._profile.__exit__(*exc)
            os.makedirs(os.path.dirname(self.trace_path()), exist_ok=True)
            self._profile.export_chrome_trace(self.trace_path())
            self._profile = None
        return False


def profile_training(trainer, num_steps: int = 20, trace: bool = False) -> Dict[str, Any]:
    """A short profiled training run of ``trainer`` (an ``AnemoiTrainer``)
    at its first rollout: the sections ``dataloader`` (the host batch),
    ``transfer`` (to the device) and ``train_step``; returns the report's
    path, the speed report and the data loader's batches a second."""
    prof = BenchmarkProfiler(os.path.join(trainer.output_dir, "profile"), trace=trace,
                             device=trainer.device)
    rollout = trainer.rollout_schedule.start
    trainer.datamodule.set_rollout(rollout)
    train_step, _ = trainer._get_step_fns(rollout)
    n = 0
    with prof:
        batches = iter(trainer.datamodule.train_batches(epoch=0))
        while n < num_steps:
            with prof.section("dataloader"):
                try:
                    batch_np = next(batches)
                except StopIteration:
                    break
            with prof.section("transfer", device=True):
                batch = trainer.put_batch(batch_np)
            prof.start_step()
            with prof.section("train_step", device=True):
                trainer.state, metrics = train_step(trainer.state, batch)
            prof.end_step()
            n += 1
    grid_points = sum(trainer.interface.model_graph.num_nodes[ds] for ds in trainer.data_indices)
    report_path = prof.write_reports(
        {"config": {"rollout": rollout, "steps": n, "grid_points": grid_points}})
    result = {"report": report_path, **prof.speed_report(grid_points=grid_points)}
    if trace:
        result["trace"] = prof.trace_path()
    dl = prof.time_report().get("dataloader")
    if dl and dl["total_s"] > 0:
        result["dataloader_batches_per_s"] = dl["count"] / dl["total_s"]
    return result
