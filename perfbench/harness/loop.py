"""What the drivers share: a run's arguments and outcome, the reference
built for a run's inputs, and small helpers of the timed loop.

A driver is a file ``perfbench/drivers/<driver>.py``, found by the name a
traffic mix gives under ``driver``.  It defines ``END_TO_END`` (the
end-to-end metrics it measures), ``run(run: Run) -> Outcome`` and
``calibrate(inputs, traffic, seed, device, kind)``, the compared numbers
of the control (``kind`` "control") or of a planted fault in the
program's place (see ``perfbench/calibrate.py``).

A driver builds the program once, drives it from the seed through its
first steps (the numbers the reference is compared with come from these
steps and from the window's own outputs), warms up, then measures for the
run's seconds.  After the window it reads the memory peak, profiles a
short stretch with ``--trace 1``, frees the program and runs the reference.
"""

from __future__ import annotations

import gc
import statistics
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from perfbench.harness import card
from perfbench.harness.inputs import reference_graph
from perfbench.harness.readers import ReadContext
from perfbench.reference.procedures import Normaliser

WARMUP_STEPS = 2


@dataclass
class Run:
    config: dict
    traffic: dict
    seed: int
    seconds: float
    trace: bool
    device: torch.device
    t_start: float


@dataclass
class Outcome:
    e2e: Dict[str, float]
    attempted: int
    failed: int
    checks: Dict[str, tuple]  # name -> (value, limit)
    memory_peak: int
    trace: object = None
    ctx: Optional[ReadContext] = None
    notes: Dict[str, float] = field(default_factory=dict)


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def free(device):
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def memory_peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0


def reference(inputs, device, precision=None, checkpoint_blocks: bool = False):
    """The configuration's plain reference on ``device`` (float32, TF32 off;
    or the control's ``precision``) and its normaliser."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    precision = precision or inputs.ref.Precision()
    ref = inputs.ref.Reference(inputs.config["model"], reference_graph(inputs, device),
                               inputs.variables, precision, checkpoint_blocks)
    s = inputs.statistics
    return ref, Normaliser(s["mean"], s["stdev"], ref, device)


def serving_dtype(config: dict) -> torch.dtype:
    return torch.bfloat16 if config["precision"] in ("bf16", "bfloat16") else torch.float32


def import_program() -> float:
    """Import the program's modules a run uses; returns the seconds."""
    t0 = time.perf_counter()
    import anemoi_tpu_torch.graphs.create  # noqa: F401
    import anemoi_tpu_torch.inference  # noqa: F401
    import anemoi_tpu_torch.models.interface  # noqa: F401
    import anemoi_tpu_torch.training.step  # noqa: F401
    return time.perf_counter() - t0


def card_state(device) -> str:
    return card.state() if device.type == "cuda" else "cpu"


def quartiles(times) -> str:
    if len(times) < 2:
        return "n/a"
    return " ".join(f"{1e3 * q:.1f}" for q in statistics.quantiles(times, n=4))


def p90(values):
    return statistics.quantiles(values, n=10)[-1] if len(values) > 1 else values[0]
