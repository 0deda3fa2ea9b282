"""Training callbacks.

Port of ``anemoi_tpu.training.callbacks``: ``CheckVariableOrder``,
``EarlyStopping``, ``TimeLimit``, ``WeightAveraging`` (EMA or SWA of the
parameters, updated on the device with ``torch._foreach_*`` and no host
sync), ``LearningRateMonitor``, ``RolloutEvalCallback`` (extended-rollout
validation metrics) and ``PerTimestepMetrics``.  Callbacks receive the
trainer from its loop hooks (``on_train_start``, ``on_step``,
``on_validation``, ``should_stop``).

The plot callbacks (``PlotSample``, ``PlotEnsembleSample``,
``PlotSpectrum``, ``PlotHistogram``, ``GraphTrainableFeaturesPlot``,
``LossCurvePlot``) need matplotlib and are not ported: building one raises
``NotImplementedError``.
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

CALLBACKS: Dict[str, Callable] = {}


def register_callback(name: str):
    def deco(cls):
        CALLBACKS[name] = cls
        return cls

    return deco


class Callback:
    def on_train_start(self, trainer) -> None: ...

    def on_step(self, trainer, step: int, metrics: Dict[str, Any]) -> None: ...

    def on_validation(self, trainer, step: int, val_metrics: Dict[str, Any]) -> None: ...

    def should_stop(self, trainer) -> bool:
        return False


@register_callback("CheckVariableOrder")
class CheckVariableOrder(Callback):
    """Check the dataset's variable order against the model's (and against
    the order a checkpoint recorded, when the trainer has one) before the
    first step."""

    def on_train_start(self, trainer) -> None:
        from anemoi_tpu_torch.data_indices.collection import compare_variables

        ckpt_indices = getattr(trainer, "ckpt_name_to_index", None)
        for name, idx in trainer.data_indices.items():
            data_n2i = trainer.datamodule.name_to_index.get(name)
            if data_n2i is None:
                continue
            compare_variables(idx.name_to_index, data_n2i)
            if ckpt_indices and name in ckpt_indices:
                compare_variables(ckpt_indices[name], data_n2i)


@register_callback("EarlyStopping")
class EarlyStopping(Callback):
    """Stop when the monitored validation metric stops improving."""

    def __init__(self, monitor: str = "val_loss", patience: int = 5, min_delta: float = 0.0,
                 mode: str = "min"):
        self.monitor = monitor
        self.patience = patience
        self.min_delta = min_delta
        self.sign = 1.0 if mode == "min" else -1.0
        self.best = float("inf")
        self.bad_epochs = 0
        self._stop = False

    def on_validation(self, trainer, step, val_metrics):
        value = val_metrics.get(self.monitor)
        if value is None:
            return
        score = self.sign * float(value)
        if score < self.best - self.min_delta:
            self.best = score
            self.bad_epochs = 0
        else:
            self.bad_epochs += 1
            if self.bad_epochs >= self.patience:
                self._stop = True

    def should_stop(self, trainer):
        return self._stop


@register_callback("TimeLimit")
class TimeLimit(Callback):
    """Stop gracefully after a wall-clock limit (seconds, or ``HH:MM:SS``)."""

    def __init__(self, limit_s: float = 0.0, limit: Optional[str] = None):
        if limit:
            parts = [float(p) for p in str(limit).split(":")]
            limit_s = sum(v * 60**i for i, v in enumerate(reversed(parts)))
        self.limit_s = float(limit_s)
        self.start = time.time()

    def should_stop(self, trainer):
        return self.limit_s > 0 and (time.time() - self.start) > self.limit_s


@register_callback("WeightAveraging")
class WeightAveraging(Callback):
    """EMA (``kind="ema"``, ``decay``) or SWA (``kind="swa"``, the uniform
    running mean) of the parameters, kept in ``avg_params`` (tensors on the
    device, in ``interface.parameters()`` order)."""

    def __init__(self, decay: float = 0.999, kind: str = "ema", update_every: int = 1):
        self.decay = decay
        self.kind = kind
        self.update_every = max(1, int(update_every))
        self.avg_params = None
        self._count = 0

    @torch.no_grad()
    def on_step(self, trainer, step, metrics):
        if step % self.update_every:
            return
        params = [p.detach() for p in trainer.interface.parameters()]
        if self.avg_params is None:
            self.avg_params = [p.clone() for p in params]
            self._count = 1
            return
        if self.kind == "swa":
            self._count += 1
            decay = 1.0 - 1.0 / self._count
        else:
            decay = self.decay
        # avg <- decay * avg + (1 - decay) * p
        torch._foreach_lerp_(self.avg_params, params, 1.0 - decay)


@register_callback("LearningRateMonitor")
class LearningRateMonitor(Callback):
    def on_step(self, trainer, step, metrics):
        metrics["lr"] = float(trainer.lr_schedule(step))


def _mean_over_val_batches(trainer, fn, max_batches: int, keep=lambda k: True) -> Dict:
    agg: Dict[str, list] = {}
    for i, batch_np in enumerate(trainer.datamodule.val_batches()):
        if i >= max_batches:
            break
        out = fn(trainer.put_batch(batch_np))
        for k, v in out.items():
            if keep(k):
                agg.setdefault(k, []).append(float(v))
    return {k: float(np.mean(vals)) for k, vals in agg.items()}


@register_callback("RolloutEvalCallback")
class RolloutEvalCallback(Callback):
    """Extended-rollout validation metrics (``rmse/<ds>/<group>/<step>`` up
    to ``rollout``) on the first ``max_batches`` validation batches."""

    def __init__(self, rollout: int = 4, every_n_validations: int = 1, max_batches: int = 2):
        self.rollout = rollout
        self.every = max(1, every_n_validations)
        self.max_batches = max_batches
        self._fn = None
        self._n = 0

    def on_train_start(self, trainer) -> None:
        # built here, so that a model it cannot run (one that draws noise)
        # is refused before the first step; the JAX callback fails at the
        # first validation
        from anemoi_tpu_torch.training.metrics import make_rollout_eval_fn

        self._fn = make_rollout_eval_fn(trainer.interface, self.rollout)

    def on_validation(self, trainer, step, val_metrics):
        self._n += 1
        if self._n % self.every:
            return
        trainer.datamodule.set_rollout(max(self.rollout, trainer.datamodule.rollout))
        val_metrics.update(_mean_over_val_batches(trainer, self._fn, self.max_batches))


@register_callback("PerTimestepMetrics")
class PerTimestepMetrics(Callback):
    """Validation metrics broken down by the model's output timestep
    (``rmse/<ds>/<group>/t_<k>``), for models predicting several steps at
    once."""

    def __init__(self, every_n_validations: int = 1, max_batches: int = 2):
        self.every = max(1, every_n_validations)
        self.max_batches = max_batches
        self._fn = None
        self._n = 0

    def on_validation(self, trainer, step, val_metrics):
        self._n += 1
        if self._n % self.every:
            return
        if trainer.interface.model.n_step_output <= 1:
            return
        from anemoi_tpu_torch.training.metrics import make_rollout_eval_fn

        if self._fn is None:
            self._fn = make_rollout_eval_fn(trainer.interface, rollout=1, per_timestep=True)
        val_metrics.update(_mean_over_val_batches(trainer, self._fn, self.max_batches,
                                                  keep=lambda k: "/t_" in k))


class _PlotCallback(Callback):
    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            f"{type(self).__name__} needs matplotlib and is not ported to anemoi_tpu_torch"
        )


for _name in ("PlotSample", "PlotEnsembleSample", "PlotSpectrum", "PlotHistogram",
              "GraphTrainableFeaturesPlot", "LossCurvePlot"):
    CALLBACKS[_name] = type(_name, (_PlotCallback,), {})


def build_callbacks(configs) -> list:
    out = []
    for cfg in configs or []:
        cfg = dict(cfg)
        name = cfg.pop("name", None)
        if name not in CALLBACKS:
            raise KeyError(f"Unknown callback '{name}'. Known: {sorted(CALLBACKS)}")
        out.append(CALLBACKS[name](**cfg))
    return out
