"""Training orchestration.

Port of ``anemoi_tpu.training.trainer`` (``RolloutSchedule``,
``AnemoiTrainer``) on one device: config -> graph (loaded from
``graph.save_path`` or built and saved there) -> datasets and
``DataModule`` -> ``AnemoiModelInterface`` (float32 master weights) ->
losses and scalers -> optimizer -> a loop over eager steps with logging,
validation, checkpoints, the rollout curriculum and graceful stops.  It
writes the JAX trainer's ``metrics.jsonl`` records with the same keys, the
training checkpoints under ``checkpoints/`` and the inference bundle under
``inference/``.

The device is the CUDA card unless ``hardware.platform`` is ``cpu``; with
no card visible the trainer raises (no silent fallback).  Batches are
staged on the device by ``data/prefetch.py`` while the current step runs.
The loop does not wait for the device on every step: the step's metrics
stay tensors, and ``.item()`` is called only at ``log_interval`` (where the
JAX trainer calls ``float()``).

Accepted with no effect: ``training.precompile_rollouts`` (there is no
program to compile ahead) and ``training.donate_state`` (the step updates
the state in place).

``training.checkpoint_pipeline`` (``training/checkpoint_pipeline.py``) runs
on the fresh model's state dict before the optimizer is built, as the JAX
trainer runs it: its weights are loaded, the pipeline's health checked, the
variable order it recorded kept for ``CheckVariableOrder``
(``ckpt_name_to_index``) and the checkpoint's variables metadata checked
against the datasets'; the parameters a ``freeze`` modifier names get a
zero update after every optimizer step (``Optimizer.freeze``), so their
gradients are still computed and the weights stay bit for bit.

Data and model parallelism (JAX ``trainer.py`` mesh): ``hardware.num_devices``
ranks, started by a launcher (``torchrun``, the ``ANEMOI_TPU_*`` contract of
``parallel/distributed.py``, or ``cli train``, which starts them itself),
form the mesh ``data x model x ensemble`` with ``num_devices_per_model``
ranks in a model group and ``num_devices_per_ensemble`` in an ensemble
group; ``num_model_shards`` is written into the model config, and the
model runs its ``shard_strategy`` (``edges``, the halo exchange, or
``heads``) over the model group, the ensemble step its block of
``training.ensemble_size`` members on each rank of the ensemble group.  The
transport task runs on the data and model axes (``training/transport_step.py``);
the ranks of an ensemble group train it as replicas.  Each
rank is on the device of the backend rule (``parallel/distributed.py``).
``dataloader.batch_size`` is per data group; every rank samples the same
seeded anchor order and reads only its batch rows and, with
``dataloader.shard_grid`` (default on), its model block of the grid.
``training.optimizer.zero`` shards the optimizer state over the data group
(``training/optimizers.py``).  Rank 0 alone logs, writes ``metrics.jsonl``,
the checkpoints (the ZeRO state gathered first, by every rank) and the
bundle; validation and the ``RolloutEvalCallback`` run on every rank with
their metrics reduced, and a stop is agreed by all ranks.

The transport task (``training.task: transport``, the presets
``transport_*.yaml``) trains with ``training/transport_step.py``'s
``make_transport_step_fns``, configured by ``training.transport``
(``objective``, ``edm``, ``tendency``, ``interpolant_gamma``, ``source``,
``sigma_dist``, ``beta_schedule``, ``sigma_schedule``), as the JAX trainer
routes it; its bundle carries that config for ``predict``.  The
``RolloutEvalCallback`` of the default diagnostics runs the deterministic
rollout, which a transport model cannot take: it refuses the model before
the first step (the JAX callback fails at the first validation), so a
transport preset trains with ``diagnostics.callbacks`` set without it.

Limited-area and stretched-grid training (``training.output_mask``: a
boolean node attribute per dataset): the loss is scored inside the area
only (an ``output_mask`` grid scaler appended to the loss's scalers) and the
rollout re-forces the boundary from the truth (``make_step_fns``'s
``output_masks``).
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional

import torch

from anemoi_tpu_torch.data.datamodule import DataModule
from anemoi_tpu_torch.data.dataset import open_dataset
from anemoi_tpu_torch.data.prefetch import HostToDevice, maybe_prefetch, ready_batch
from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.graphs.create import GraphCreator
from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.parallel.distributed import all_reduce, local_batch_plan, maybe_initialize
from anemoi_tpu_torch.parallel.mesh import MeshSpec, batch_sharding, create_mesh
from anemoi_tpu_torch.training.callbacks import build_callbacks
from anemoi_tpu_torch.training.checkpoint import CheckpointManager, save_inference_checkpoint
from anemoi_tpu_torch.training.loggers import build_loggers
from anemoi_tpu_torch.training.masks import build_output_masks
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.base import variable_scaling_summary
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.optimizers import build_lr_schedule, build_optimizer
from anemoi_tpu_torch.training.step import TrainState, make_step_fns
from anemoi_tpu_torch.training.transport_step import make_transport_step_fns
from anemoi_tpu_torch.utils.device import resolve_device
from anemoi_tpu_torch.utils.tracing import span

LOGGER = logging.getLogger(__name__)
_END = object()  # the end of an epoch's batches


class RolloutSchedule:
    """Rollout curriculum: start value, increment every N epochs, up to a
    maximum."""

    def __init__(self, config: Optional[dict]) -> None:
        cfg = dict(config or {})
        self.start = int(cfg.get("start", 1))
        self.epoch_increment = int(cfg.get("epoch_increment", 0))
        self.maximum = int(cfg.get("max", self.start))

    def at_epoch(self, epoch: int) -> int:
        if self.epoch_increment <= 0:
            return self.start
        return min(self.start + (epoch // self.epoch_increment), self.maximum)


def trainer_device(hardware: Optional[dict]) -> torch.device:
    """The device of a one-rank run: ``hardware.platform`` ``cpu`` selects
    the CPU, ``gpu``/``cuda`` or nothing the CUDA card (which must be
    visible)."""
    hw = dict(hardware or {})
    platform = hw.get("platform")
    if platform is None:
        return resolve_device(None)
    platform = str(platform).lower()
    if platform == "cpu":
        return torch.device("cpu")
    if platform in ("gpu", "cuda"):
        return resolve_device("cuda")
    raise ValueError(f"hardware.platform '{platform}': anemoi_tpu_torch runs on cpu or gpu")


class AnemoiTrainer:
    def __init__(self, config: Dict[str, Any], output_dir: Optional[str] = None) -> None:
        self.config = config
        self.output_dir = output_dir or config.get("output_dir", "runs/default")
        os.makedirs(self.output_dir, exist_ok=True)
        if bool((config.get("diagnostics", {}).get("debug") or {}).get("anomaly_detection",
                                                                         False)):
            torch.autograd.set_detect_anomaly(True)
            LOGGER.info("Anomaly detection on: torch.autograd.set_detect_anomaly")

        training_cfg = dict(config.get("training", {}))
        task_group = dict(config.get("task", {}) or {})
        if task_group.get("name") and "task" not in training_cfg:
            training_cfg["task"] = str(task_group["name"])
            config = dict(config)
            config["training"] = training_cfg
            self.config = config
        self._init_mesh(config.get("hardware"))
        if self.mesh_spec.model > 1:
            # the model builds its halo tables over the model group
            config = dict(config)
            config["model"] = {**config.get("model", {}), "num_model_shards": self.mesh_spec.model}
            self.config = config

        # --- graph ----------------------------------------------------
        graph_cfg = dict(config.get("graph", {}))
        save_path = graph_cfg.get("save_path")
        recipe = graph_cfg.get("recipe", graph_cfg)
        if save_path and os.path.exists(save_path) and not graph_cfg.get("overwrite", False):
            self.graph = Graph.load(save_path)
        else:
            self.graph = GraphCreator(recipe).create(save_path, overwrite=True)

        # --- data -----------------------------------------------------
        data_cfg = dict(config.get("data", {}))
        datasets = {name: open_dataset(ds_cfg)
                    for name, ds_cfg in data_cfg.get("datasets", {}).items()}
        if not datasets:
            raise ValueError("config.data.datasets must define at least one dataset")
        model_cfg = config.get("model", {})
        loader_cfg = config.get("dataloader", {})
        self.rollout_schedule = RolloutSchedule(training_cfg.get("rollout"))
        self.datamodule = DataModule(
            datasets,
            n_step_input=int(model_cfg.get("n_step_input", 2)),
            n_step_output=int(model_cfg.get("n_step_output", 1)),
            rollout=self.rollout_schedule.start,
            # per data group, as in the JAX trainer: the loader samples the global batch
            batch_size=int(loader_cfg.get("batch_size", 1)) * self.mesh_spec.data,
            validation_fraction=float(loader_cfg.get("validation_fraction", 0.15)),
        )
        if self.mesh is not None:
            self._setup_local_loading(bool(loader_cfg.get("shard_grid", True)))
        self._put = HostToDevice(self.device)

        # --- indices and model ----------------------------------------
        self.data_indices = {
            name: IndexCollection(ds.name_to_index, forcing=data_cfg.get("forcing"),
                                  diagnostic=data_cfg.get("diagnostic"),
                                  target=data_cfg.get("target"))
            for name, ds in datasets.items()
        }
        self.interface = AnemoiModelInterface(
            config=config, graph=self.graph, data_indices=self.data_indices,
            statistics=self.datamodule.statistics, device=self.device, training=True,
            mesh=self.mesh,
        )

        # --- output masks (limited area, stretched grid) ------------
        self.output_masks = build_output_masks(training_cfg.get("output_mask"), self.graph)

        # --- losses ---------------------------------------------------
        self.losses = {}
        for name, ds in datasets.items():
            scalers = create_scalers(
                training_cfg.get("scalers"), graph=self.graph,
                data_indices=self.data_indices[name], statistics=ds.statistics,
                statistics_tendencies=ds.statistics_tendencies,
                variable_groups=training_cfg.get("variable_groups"),
                metadata_variables=getattr(ds, "variables_metadata", None),
            )
            loss_cfg = dict(training_cfg.get("loss", {"name": "WeightedMSELoss"}))
            if name in self.output_masks:
                # scored inside the area of interest only
                scalers["output_mask"] = (("grid",), self.output_masks[name].loss_scaler())
                if "scalers" in loss_cfg:
                    loss_cfg["scalers"] = list(loss_cfg["scalers"]) + ["output_mask"]
            self.losses[name] = get_loss_function(
                loss_cfg, scalers, graph=self.graph, dataset=name,
                data_indices=self.data_indices[name],
                variables_metadata=getattr(ds, "variables_metadata", None),
            )
            # the effective per-variable loss weighting, once at startup
            LOGGER.info("variable loss scaling [%s]: %s", name,
                        variable_scaling_summary(self.losses[name], self.data_indices[name]))

        # --- checkpoint pipeline, optimizer / state ---------------------
        self.ckpt_name_to_index = None
        frozen = []
        if training_cfg.get("checkpoint_pipeline"):
            frozen = self._run_checkpoint_pipeline(list(training_cfg["checkpoint_pipeline"]),
                                                   datasets)
        self.lr_schedule = build_lr_schedule(training_cfg.get("lr", {}))
        self.tx = build_optimizer(training_cfg, self.lr_schedule,
                                  data_group=self.mesh.group("data") if self.mesh else None)
        self.state = TrainState.create(self.interface, self.tx)
        if frozen:
            named = dict(self.interface.named_parameters())
            self.state.optimizer.freeze(named[name] for name in frozen if name in named)
        self.num_params = sum(p.numel() for p in self.interface.parameters())
        LOGGER.info("Model has %.2fM parameters", self.num_params / 1e6)

        diag = config.get("diagnostics", {})
        self.ckpt = CheckpointManager(os.path.join(self.output_dir, "checkpoints"),
                                      max_to_keep=int(diag.get("checkpoint_keep", 3)))
        if training_cfg.get("resume", False):
            if self.ckpt.restore(self.state) is not None:
                LOGGER.info("Resumed from step %d", self.state.step)

        self._step_fns: Dict[int, Any] = {}  # rollout -> (train_step, eval_step)
        self._log_file = None  # metrics.jsonl, open while train() runs
        self.callbacks = build_callbacks(diag.get("callbacks"))
        self.loggers = build_loggers(diag.get("loggers"), self.output_dir) if self.is_root else []
        for lg in self.loggers:
            lg.log_params({"config": dict(config), "num_params": int(self.num_params)})

    # ------------------------------------------------------------------
    def _run_checkpoint_pipeline(self, stages: list, datasets: dict) -> list:
        """Load weights through the checkpoint pipeline (JAX
        ``trainer.py:221-266``); returns the names of the frozen parameters."""
        from anemoi_tpu_torch.training.checkpoint_pipeline import (
            CheckpointContext, CheckpointPipeline, validate_pipeline_health,
        )
        from anemoi_tpu_torch.utils.variables_metadata import (
            check_variables_metadata_compatibility, extract_variables_metadata_from_checkpoint,
        )

        params = {k: v.detach().cpu() for k, v in self.interface.state_dict().items()}
        ctx = CheckpointPipeline(stages).run(CheckpointContext(params=params))
        validate_pipeline_health(ctx)
        self.interface.load_state_dict(ctx.params, strict=True)
        # the variable order the checkpoint recorded, for CheckVariableOrder
        self.ckpt_name_to_index = ctx.metadata.get("name_to_index")
        check_variables_metadata_compatibility(
            extract_variables_metadata_from_checkpoint(
                ctx.metadata.get("bundle_metadata", {}), datasets.keys()),
            {name: {"variables_metadata": getattr(ds, "variables_metadata", None)}
             for name, ds in datasets.items()},
        )
        LOGGER.info("Checkpoint pipeline: %s", {k: v for k, v in ctx.metadata.items()
                                                if k != "bundle_metadata"})
        return [name for name, trainable in (ctx.trainable_mask or {}).items() if not trainable]

    def _init_mesh(self, hardware: Optional[dict]) -> None:
        """The ranks' mesh from ``hardware`` (JAX ``trainer.py:101-131``):
        join the world a launcher started, check it against
        ``hardware.num_devices`` and build the data and model groups."""
        hw = dict(hardware or {})
        device = trainer_device(hw)
        launch = maybe_initialize(hw.get("platform"))
        world = launch.world if launch is not None else 1
        n_dev = int(hw.get("num_devices", world))
        if n_dev != world:
            raise ValueError(
                f"hardware.num_devices {n_dev} with {world} rank(s) running: start the ranks "
                "with torchrun, the ANEMOI_TPU_* environment or `cli train`, which starts "
                "hardware.num_devices local ranks itself")
        self.mesh_spec = MeshSpec.from_config(hw, num_devices=world)
        self.device = launch.device if launch is not None else device
        self.mesh = create_mesh(self.mesh_spec, self.device) if world > 1 else None
        self.is_root = self.mesh is None or self.mesh.is_root
        if self.mesh is not None:
            LOGGER.info("Mesh: data=%d model=%d ensemble=%d (rank %d on %s)",
                        self.mesh_spec.data, self.mesh_spec.model, self.mesh_spec.ensemble,
                        self.mesh.rank, self.device)

    def _setup_local_loading(self, shard_grid: bool) -> None:
        """Each rank reads its batch rows and, with ``shard_grid``, its
        model block of the grid (JAX ``_setup_multihost_loading``)."""
        plan = local_batch_plan(batch_sharding(self.mesh, shard_grid=shard_grid), {
            name: (self.datamodule.batch_size, self.datamodule.window, 1, ds.num_grid_points,
                   len(ds.variables))
            for name, ds in self.datamodule.datasets.items()})
        self.datamodule.local_plan = {name: (slc[0], slc[3]) for name, slc in plan.items()}
        LOGGER.info("rank %d reads %s", self.mesh.rank,
                    {n: (f"B[{b.start}:{b.stop}]", f"G[{g.start}:{g.stop}]")
                     for n, (b, g) in self.datamodule.local_plan.items()})

    def _agreed(self, flag: bool) -> bool:
        """``flag`` on any rank (a stop every rank takes together)."""
        if self.mesh is None:
            return flag
        t = torch.tensor([float(flag)], device=self.device)
        return bool(all_reduce(t, torch.distributed.group.WORLD, torch.distributed.ReduceOp.MAX))

    def put_batch(self, batch_np) -> Dict[str, torch.Tensor]:
        """A host batch on the trainer's device, ready for the next step."""
        return ready_batch(self._put(batch_np))

    def _get_step_fns(self, rollout: int):
        if rollout not in self._step_fns:
            cfg = self.config.get("training", {})
            if str(cfg.get("task", "forecaster")) == "transport":
                self._step_fns[rollout] = self._transport_step_fns(cfg)
                return self._step_fns[rollout]
            self._step_fns[rollout] = make_step_fns(
                self.interface,
                self.losses,
                rollout=rollout,
                remat_rollout=bool(cfg.get("remat_rollout", True)),
                remat_policy=cfg.get("remat_policy"),
                ensemble_size=int(cfg.get("ensemble_size", 1)),
                output_masks=self.output_masks or None,
                precision=str(cfg.get("precision", "fp32")),
                fp32_head=bool(cfg.get("fp32_head", False)),
                task=str(cfg.get("task", "forecaster")),
                with_grad_norm=bool(cfg.get("log_grad_norm", True)),
            )
        return self._step_fns[rollout]

    def _transport_step_fns(self, cfg: dict):
        from anemoi_tpu_torch.models.transport.objectives import EDMConfig

        tcfg = dict(cfg.get("transport") or {})
        return make_transport_step_fns(
            self.interface,
            self.losses,
            objective=str(tcfg.get("objective", "edm")),
            edm=EDMConfig.from_config(tcfg.get("edm")),
            tendency=bool(tcfg.get("tendency", False)),
            interpolant_gamma=float(tcfg.get("interpolant_gamma", 0.0)),
            source=str(tcfg.get("source", "gaussian")),
            sigma_dist=tcfg.get("sigma_dist"),
            beta_schedule=str(tcfg.get("beta_schedule", "linear")),
            sigma_schedule=str(tcfg.get("sigma_schedule", "brownian_bridge")),
            precision=str(cfg.get("precision", "fp32")),
        )

    def _log(self, record: Dict[str, Any]) -> None:
        if self._log_file is None:  # ranks other than 0
            return
        self._log_file.write(json.dumps(record, default=float) + "\n")
        self._log_file.flush()

    # ------------------------------------------------------------------
    def train(self) -> Dict[str, Any]:
        if not self.is_root:
            return self._train()
        with open(os.path.join(self.output_dir, "metrics.jsonl"), "a") as self._log_file:
            return self._train()

    def _train(self) -> Dict[str, Any]:
        cfg = self.config.get("training", {})
        diag = self.config.get("diagnostics", {})
        max_epochs = int(cfg.get("max_epochs", 1))
        max_steps = int(cfg.get("max_steps", 10**9))
        log_interval = int(diag.get("log_interval", 10))
        ckpt_interval = int(diag.get("checkpoint_interval", 500))
        time_limit_s = float(cfg.get("time_limit_s", 0)) or None
        prefetch = int(self.config.get("dataloader", {}).get("prefetch", 2))

        for cb in self.callbacks:
            cb.on_train_start(self)

        t_start = time.time()
        t_last_log = t_start
        steps_since_log = 0
        global_step = int(self.state.step)
        last_metrics = None  # device values; read lazily (no per-step sync)
        last_loss = float("nan")
        stop = False

        for epoch in range(max_epochs):
            rollout = self.rollout_schedule.at_epoch(epoch)
            self.datamodule.set_rollout(rollout)
            train_step, _ = self._get_step_fns(rollout)

            t_epoch = time.time()
            n_batches = 0
            batch_iter = maybe_prefetch(self.datamodule.train_batches(epoch), self._put, prefetch)
            while True:
                with span("anemoi.trainer.data_wait"):
                    batch = next(batch_iter, _END)
                if batch is _END:
                    break
                self.state, metrics = train_step(self.state, batch)
                last_metrics = metrics
                global_step += 1
                n_batches += 1

                for cb in self.callbacks:
                    cb.on_step(self, global_step, metrics)
                steps_since_log += 1
                if global_step % log_interval == 0:
                    loss = float(metrics["loss"])
                    last_loss = loss
                    now = time.time()
                    interval_steps = steps_since_log
                    steps_since_log = 0
                    rec = {
                        "step": global_step,
                        "epoch": epoch,
                        "rollout": rollout,
                        "loss": loss,
                        "grad_norm": float(metrics["grad_norm"]),
                        "lr": float(self.lr_schedule(global_step)),
                        "elapsed_s": now - t_start,
                        "steps_per_s": interval_steps / max(now - t_last_log, 1e-9),
                        "samples_per_s": interval_steps * self.datamodule.batch_size
                        / max(now - t_last_log, 1e-9),
                    }
                    t_last_log = now
                    self._log(rec)
                    for lg in self.loggers:
                        lg.log_metrics({k: v for k, v in rec.items()
                                        if isinstance(v, (int, float))}, global_step)
                    LOGGER.info("step %d epoch %d loss %.5f grad %.3f",
                                global_step, epoch, rec["loss"], rec["grad_norm"])
                if global_step % ckpt_interval == 0:
                    self.ckpt.save(global_step, self.state, write=self.is_root)
                if global_step >= max_steps:
                    stop = True
                    break
                if self._agreed(bool(time_limit_s) and (time.time() - t_start) > time_limit_s):
                    LOGGER.info("Time limit reached; stopping gracefully")
                    stop = True
                    break
                if self._agreed(any(cb.should_stop(self) for cb in self.callbacks)):
                    LOGGER.info("Callback requested stop")
                    stop = True
                    break
            batch_iter.close()  # stop and join the prefetch thread after an early break
            if n_batches:
                self._log({"epoch": epoch, "epoch_time_s": time.time() - t_epoch,
                           "batches": n_batches})
            val = self.validate(rollout)
            if val is not None:
                for cb in self.callbacks:
                    cb.on_validation(self, global_step, val)
                self._log({"step": global_step, "epoch": epoch, **val})
                for lg in self.loggers:
                    lg.log_metrics(val, global_step)
            if not stop and self._agreed(any(cb.should_stop(self) for cb in self.callbacks)):
                LOGGER.info("Callback requested stop after validation")
                stop = True
            if stop:
                break
        if last_metrics is not None:
            last_loss = float(last_metrics["loss"])

        self.ckpt.save(global_step, self.state, write=self.is_root)
        if self.is_root:
            self.save_inference_checkpoint()
        for lg in self.loggers:
            lg.finalize()
        return {"final_loss": last_loss, "steps": global_step}

    # ------------------------------------------------------------------
    def validate(self, rollout: Optional[int] = None) -> Optional[Dict[str, float]]:
        """Validation pass: the mean over validation batches of ``val_loss``
        and the per-variable-group RMSE in physical units
        (``rmse/<dataset>/<group>/<step>``).  ``training.validation_rollout``
        fixes the rollout apart from the training curriculum."""
        rollout = int(self.config.get("training", {}).get("validation_rollout", 0)) \
            or rollout or self.rollout_schedule.start
        train_rollout = self.datamodule.rollout
        if rollout != train_rollout:
            self.datamodule.set_rollout(rollout)
        sums: Dict[str, float] = {}
        n = 0
        try:
            _, eval_step = self._get_step_fns(rollout)
            for batch_np in self.datamodule.val_batches():
                m = eval_step(self.state, self.put_batch(batch_np))
                for k, v in m.items():
                    sums[k] = sums.get(k, 0.0) + float(v)
                n += 1
        finally:
            if rollout != train_rollout:
                self.datamodule.set_rollout(train_rollout)
        if not n:
            return None
        return {k: v / n for k, v in sums.items()}

    # ------------------------------------------------------------------
    def save_inference_checkpoint(self) -> None:
        di_config = {
            ds: {"name_to_index": idx.name_to_index, "forcing": idx.forcing,
                 "diagnostic": idx.diagnostic, "target": idx.target}
            for ds, idx in self.data_indices.items()
        }
        save_inference_checkpoint(
            os.path.join(self.output_dir, "inference"),
            self.interface.state_dict(),
            dict(self.config),
            di_config,
            self.datamodule.statistics,
            metadata={
                "num_params": int(self.num_params),
                "dataset": {
                    name: {"variables_metadata": getattr(ds, "variables_metadata", None)}
                    for name, ds in self.datamodule.datasets.items()
                },
            },
        )
