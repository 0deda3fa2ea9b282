"""Optimizers and learning-rate schedules.

Port of ``anemoi_tpu.training.optimizers``: ``build_lr_schedule`` (optax's
``warmup_cosine_decay_schedule``, in plain Python) and ``build_optimizer``
(``adamw``/``adam`` on ``torch.optim`` with the JAX registry's defaults,
after value or global-norm gradient clipping).  AdEMAMix is not ported.

As in optax, the schedule is read at the update count *before* it is
incremented: the first update uses ``schedule(0)``, which is 0 with warmup.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Optional

import torch

Schedule = Callable[[int], float]


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int,
    end_value: float = 0.0, exponent: float = 1.0,
) -> Schedule:
    """Linear warmup from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then cosine decay to ``end_value`` at ``decay_steps``
    (which includes the warmup) -- optax's formula."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine_steps = decay_steps - warmup_steps
    if cosine_steps <= 0:
        raise ValueError(f"decay_steps {decay_steps} must exceed warmup_steps {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        t = min(count - warmup_steps, cosine_steps)
        decay = 0.5 * (1.0 + math.cos(math.pi * t / cosine_steps))
        return peak_value * ((1.0 - alpha) * decay**exponent + alpha)

    return schedule


def build_lr_schedule(config: dict) -> Schedule:
    """Warmup + cosine annealing to the minimum rate (config ``training.lr``:
    ``rate``, ``min``, ``warmup``, ``iterations``)."""
    rate = float(config.get("rate", 1e-4))
    min_rate = float(config.get("min", 3e-7))
    warmup = int(config.get("warmup", 1000))
    iterations = int(config.get("iterations", 300000))
    return warmup_cosine_decay_schedule(
        init_value=0.0, peak_value=rate, warmup_steps=max(warmup, 1),
        decay_steps=max(iterations, warmup + 1), end_value=min_rate,
    )


def _adamw(params, weight_decay: float = 0.0, b1: float = 0.9, b2: float = 0.95,
           eps: float = 1e-8, **_):
    return torch.optim.AdamW(params, lr=0.0, betas=(b1, b2), eps=eps, weight_decay=weight_decay)


def _adam(params, b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8, **_):
    return torch.optim.Adam(params, lr=0.0, betas=(b1, b2), eps=eps)


OPTIMIZERS = {"adamw": _adamw, "adam": _adam}


class Optimizer:
    """Gradient clipping, then a ``torch.optim`` update at the scheduled rate.
    :meth:`step` updates the parameters in place from their ``.grad``."""

    def __init__(self, params: Iterable[torch.nn.Parameter], name: str, options: dict,
                 schedule: Schedule, clip_value: float = 0.0, clip_norm: float = 0.0) -> None:
        self.params = [p for p in params if p.requires_grad]
        self.opt = OPTIMIZERS[name](self.params, **options)
        self.schedule = schedule
        self.clip_value = clip_value
        self.clip_norm = clip_norm
        self.count = 0  # updates applied so far

    def step(self) -> None:
        if self.clip_value > 0:
            torch.nn.utils.clip_grad_value_(self.params, self.clip_value)
        elif self.clip_norm > 0:
            torch.nn.utils.clip_grad_norm_(self.params, self.clip_norm)
        lr = self.schedule(self.count)
        for group in self.opt.param_groups:
            group["lr"] = lr
        self.opt.step()
        self.count += 1


def build_optimizer(config: dict, schedule: Optional[Schedule] = None):
    """``config``: ``{"optimizer": {"name": "adamw", ...}, "lr": {...},
    "gradient_clip": {"val": 32.0, "algorithm": "value" | "norm"}}``.
    Returns a factory ``params -> Optimizer`` (what ``TrainState.create``
    takes, as the JAX ``TrainState.create`` takes an optax transformation)."""
    cfg = dict(config.get("optimizer", {"name": "adamw"}))
    name = cfg.pop("name", "adamw")
    if name not in OPTIMIZERS:
        raise NotImplementedError(f"optimizer '{name}' is not ported to anemoi_tpu_torch")
    lr = schedule if schedule is not None else build_lr_schedule(config.get("lr", {}))
    clip = config.get("gradient_clip") or {}
    val = float(clip.get("val", 0.0))
    algorithm = clip.get("algorithm", "value")
    if algorithm not in ("value", "norm"):
        raise ValueError(f"unknown gradient_clip algorithm '{algorithm}'")

    def make(params: Iterable[torch.nn.Parameter]) -> Optimizer:
        return Optimizer(
            params, name, cfg, lr,
            clip_value=val if algorithm == "value" else 0.0,
            clip_norm=val if algorithm == "norm" else 0.0,
        )

    return make
