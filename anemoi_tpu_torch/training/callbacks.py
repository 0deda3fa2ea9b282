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
``LossCurvePlot``) render each due validation's figures to
``<output_dir>/plots/`` through ``training/plots.py``, on a background
thread unless ``async_plots`` is false.  They import matplotlib when they
are built, so that a run without it fails before its first step (the JAX
callbacks import it when they draw, and their executor logs the failure).
"""

from __future__ import annotations

import json
import os
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


class BasePlotCallback(Callback):
    """Shared machinery: the plots directory, the executor, the cadence."""

    def __init__(self, every_n_validations: int = 1, async_plots: bool = True):
        from anemoi_tpu_torch.training.plots import AsyncPlotExecutor, SyncPlotExecutor, _plt

        _plt()  # matplotlib, before the first step
        self.every = max(1, every_n_validations)
        self._n = 0
        self.executor = AsyncPlotExecutor() if async_plots else SyncPlotExecutor()

    def _due(self) -> bool:
        self._n += 1
        return self._n % self.every == 0

    def _plot_dir(self, trainer) -> str:
        return os.path.join(trainer.output_dir, "plots")

    def _sample(self, trainer):
        """One validation batch: (lats, lons, pred, truth, names), pred and
        truth ``[G, V_out]`` in physical units: the first sample's first
        output step (the first member's, for an ensemble)."""
        batch_np = next(iter(trainer.datamodule.val_batches()))
        with torch.no_grad():
            out = trainer.interface.predict_step(trainer.put_batch(batch_np))
        ds = sorted(batch_np)[0]
        idx = trainer.data_indices[ds]
        m = trainer.interface.model.n_step_input
        names = idx.model.output.ordered_names
        cols = np.asarray([idx.name_to_index[n] for n in names])
        truth = np.asarray(batch_np[ds][0, m, 0])[:, cols]  # [G, V_out]
        members = out[ds][0, 0].float().cpu().numpy()  # [E, G, V_out]
        self._last_members = members
        self._last_dataset = ds
        coords = trainer.graph[ds].coords
        return coords[:, 0], coords[:, 1], members[0], truth, names

    def _focus(self, trainer, lats, lons, *fields):
        """The configured focus area (``focus_area``) applied to the
        coordinates and the ``[..., G, V]`` fields; no-op without one."""
        mask = getattr(self, "_spatial_mask", None)
        if mask is None:
            from anemoi_tpu_torch.training.plots import build_spatial_mask

            mask = self._spatial_mask = build_spatial_mask(
                **(getattr(self, "focus_area", None) or {}))
        return mask.apply(trainer.graph, self._last_dataset, lats, lons, *fields), mask.tag

    def _selected(self, names) -> list:
        if self.variables:
            return [names.index(v) for v in self.variables]
        return list(range(min(self.max_vars, len(names))))


@register_callback("PlotSample")
class PlotSample(BasePlotCallback):
    """Truth / prediction / error maps of selected variables each due
    validation."""

    def __init__(self, variables: Optional[list] = None, max_vars: int = 4,
                 every_n_validations: int = 1, async_plots: bool = True,
                 focus_area: Optional[dict] = None, colormaps: Optional[list] = None):
        super().__init__(every_n_validations, async_plots)
        self.variables = variables
        self.max_vars = max_vars
        self.focus_area = focus_area
        self.colormaps = colormaps

    def on_validation(self, trainer, step, val_metrics):
        if not self._due():
            return
        from anemoi_tpu_torch.training.plots import build_colormaps, plot_sample_maps, save_figure

        lats, lons, pred, truth, names = self._sample(trainer)
        (lats, lons, pred, truth), tag = self._focus(trainer, lats, lons, pred, truth)
        sel = self._selected(names)
        cmaps = build_colormaps(self.colormaps)
        path = os.path.join(self._plot_dir(trainer), f"sample{tag}_step{step:07d}.png")
        self.executor.schedule(lambda: save_figure(
            plot_sample_maps(lats, lons, pred[:, sel], truth[:, sel], [names[i] for i in sel],
                             cmaps=cmaps), path))


@register_callback("PlotEnsembleSample")
class PlotEnsembleSample(BasePlotCallback):
    """Per-member, ensemble-mean and spread maps of an ensemble model."""

    def __init__(self, variables: Optional[list] = None, max_vars: int = 2,
                 max_members: int = 4, every_n_validations: int = 1,
                 async_plots: bool = True, focus_area: Optional[dict] = None):
        super().__init__(every_n_validations, async_plots)
        self.variables = variables
        self.max_vars = max_vars
        self.max_members = max_members
        self.focus_area = focus_area

    def on_validation(self, trainer, step, val_metrics):
        if not self._due():
            return
        from anemoi_tpu_torch.training.plots import plot_ensemble_maps, save_figure

        lats, lons, _, truth, names = self._sample(trainer)
        members = self._last_members  # [E, G, V]
        if members.shape[0] <= 1:
            return  # a deterministic model: no ensemble to show
        (lats, lons, members, truth), tag = self._focus(trainer, lats, lons, members, truth)
        for i in self._selected(names):
            path = os.path.join(self._plot_dir(trainer),
                                f"ensemble_{names[i]}{tag}_step{step:07d}.png")
            self.executor.schedule(
                lambda m=members[:, :, i], t=truth[:, i], n=names[i], p=path: save_figure(
                    plot_ensemble_maps(lats, lons, m, t, n, self.max_members), p))


@register_callback("PlotSpectrum")
class PlotSpectrum(BasePlotCallback):
    """Per-degree spherical-harmonic power spectra of prediction and truth
    (``gaussian_n`` and ``grid_kind`` pick the transform; a grid that is not
    the transform's is skipped with a warning)."""

    def __init__(self, gaussian_n: int = 0, grid_kind: str = "octahedral",
                 variables: Optional[list] = None, max_vars: int = 3,
                 every_n_validations: int = 1, async_plots: bool = True):
        super().__init__(every_n_validations, async_plots)
        self.gaussian_n = gaussian_n
        self.grid_kind = grid_kind
        self.variables = variables
        self.max_vars = max_vars

    def on_validation(self, trainer, step, val_metrics):
        if not self._due():
            return
        from anemoi_tpu_torch.training.plots import plot_power_spectra, power_spectra, save_figure

        _, _, pred, truth, names = self._sample(trainer)
        sel = self._selected(names)
        spectra = power_spectra(pred[:, sel], truth[:, sel], [names[i] for i in sel],
                                self.gaussian_n, self.grid_kind)
        if spectra is None:
            return
        path = os.path.join(self._plot_dir(trainer), f"spectrum_step{step:07d}.png")
        self.executor.schedule(lambda: save_figure(plot_power_spectra(spectra), path))


@register_callback("PlotHistogram")
class PlotHistogram(BasePlotCallback):
    """Predicted-versus-truth value histograms."""

    def __init__(self, variables: Optional[list] = None, max_vars: int = 4,
                 every_n_validations: int = 1, async_plots: bool = True,
                 focus_area: Optional[dict] = None):
        super().__init__(every_n_validations, async_plots)
        self.variables = variables
        self.max_vars = max_vars
        self.focus_area = focus_area

    def on_validation(self, trainer, step, val_metrics):
        if not self._due():
            return
        from anemoi_tpu_torch.training.plots import plot_histograms, save_figure

        lats, lons, pred, truth, names = self._sample(trainer)
        (lats, lons, pred, truth), tag = self._focus(trainer, lats, lons, pred, truth)
        sel = self._selected(names)
        path = os.path.join(self._plot_dir(trainer), f"histogram{tag}_step{step:07d}.png")
        self.executor.schedule(lambda: save_figure(
            plot_histograms(pred[:, sel], truth[:, sel], [names[i] for i in sel]), path))


@register_callback("GraphTrainableFeaturesPlot")
class GraphTrainableFeaturesPlot(BasePlotCallback):
    """The norm of each node set's trainable features on the map."""

    PREFIX, SUFFIX = "model.node_attributes.trainable_tensors.", ".trainable"

    def on_validation(self, trainer, step, val_metrics):
        if not self._due():
            return
        from anemoi_tpu_torch.training.plots import _plt, plot_field_map, save_figure

        feats = {name[len(self.PREFIX):-len(self.SUFFIX)]: p.detach().float().cpu().numpy()
                 for name, p in trainer.interface.named_parameters()
                 if name.startswith(self.PREFIX) and name.endswith(self.SUFFIX)}
        if not feats:
            return

        def render():
            plt = _plt()
            fig, axes = plt.subplots(len(feats), 1, figsize=(6, 3 * len(feats)), squeeze=False)
            for ax, (node_set, emb) in zip(axes[:, 0], sorted(feats.items())):
                coords = trainer.graph[node_set].coords
                plot_field_map(coords[:, 0], coords[:, 1], np.linalg.norm(emb, axis=-1),
                               f"|trainable| {node_set}", ax=ax)
            fig.tight_layout()
            save_figure(fig, os.path.join(self._plot_dir(trainer),
                                          f"node_features_step{step:07d}.png"))

        self.executor.schedule(render)


@register_callback("LossCurvePlot")
class LossCurvePlot(BasePlotCallback):
    """The loss against the step, from ``metrics.jsonl``."""

    def on_validation(self, trainer, step, val_metrics):
        if not self._due():
            return
        from anemoi_tpu_torch.training.plots import plot_loss_curve, save_figure

        path = os.path.join(trainer.output_dir, "metrics.jsonl")
        if not os.path.exists(path):
            return
        steps, losses, vsteps, vlosses = [], [], [], []
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if "loss" in rec and "step" in rec:
                    steps.append(rec["step"])
                    losses.append(rec["loss"])
                if "val_loss" in rec and "step" in rec:
                    vsteps.append(rec["step"])
                    vlosses.append(rec["val_loss"])
        if not steps:
            return
        out = os.path.join(self._plot_dir(trainer), f"loss_curve_step{step:07d}.png")
        self.executor.schedule(
            lambda: save_figure(plot_loss_curve(steps, losses, vsteps, vlosses), out))


def build_callbacks(configs) -> list:
    out = []
    for cfg in configs or []:
        cfg = dict(cfg)
        name = cfg.pop("name", None)
        if name not in CALLBACKS:
            raise KeyError(f"Unknown callback '{name}'. Known: {sorted(CALLBACKS)}")
        out.append(CALLBACKS[name](**cfg))
    return out
