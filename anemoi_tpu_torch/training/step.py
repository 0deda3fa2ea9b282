"""The training and validation step with autoregressive rollout.

Port of ``anemoi_tpu.training.step``: ``TrainState``, ``_index_arrays``,
``advance_input`` and ``make_step_fns`` for the forecaster task.  The JAX
step is one jitted pure function; here the step runs eagerly and updates
the master weights and the optimizer state in place.

Batch layout (data space, un-normalised): ``{ds: [B, W, E, G, V_data]}``
with ``W = n_step_input + rollout * n_step_output``.

Not ported (``NotImplementedError``): the autoencoder and
temporal-downscaler tasks, ensembles (``ensemble_size > 1``), boundary
masks, and rollout remat (``remat_rollout`` at ``rollout > 1``,
``remat_policy``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.training.metrics import variable_groups

COMPUTE_TYPES = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "16-mixed": torch.bfloat16,
                 "fp32": None, "float32": None, "32": None}


@dataclass
class TrainState:
    """Step counter, the interface holding the float32 master weights, and
    the optimizer (its state included)."""

    step: int
    interface: torch.nn.Module
    optimizer: object

    @classmethod
    def create(cls, interface: torch.nn.Module, tx: Callable) -> "TrainState":
        """``tx``: the factory of ``build_optimizer``."""
        return cls(step=0, interface=interface, optimizer=tx(interface.parameters()))

    def apply_gradients(self) -> "TrainState":
        """One optimizer update from the parameters' ``.grad``, in place."""
        self.optimizer.step()
        self.step += 1
        return self


def _index_arrays(idx: IndexCollection) -> Dict[str, np.ndarray]:
    """Index arrays of the rollout, computed on the host once.  Per
    model-INPUT variable j: prognostic ones come from the prediction
    (``from_pred[j]``), forcings from the batch at the new time
    (``from_data[j]``); ``model_out_in_data`` places the model outputs in
    the data space (the targets)."""
    n_in = idx.num_model_input_vars
    out_pos = {n: p for p, n in enumerate(idx.model.output.ordered_names)}
    is_prog = np.zeros(n_in, dtype=bool)
    from_pred = np.zeros(n_in, dtype=np.int64)
    from_data = np.zeros(n_in, dtype=np.int64)
    forcing = set(idx.forcing)
    for j, name in enumerate(idx.model.input.ordered_names):
        from_data[j] = idx.name_to_index[name]
        if name not in forcing:
            is_prog[j] = True
            from_pred[j] = out_pos[name]
    model_out_in_data = np.asarray(
        [idx.name_to_index[n] for n in idx.model.output.ordered_names], dtype=np.int64
    )
    return {
        "data_input_full": np.asarray(idx.data.input.full, dtype=np.int64),
        "model_out_in_data": model_out_in_data,
        "is_prog": is_prog,
        "from_pred": from_pred,
        "from_data": from_data,
    }


def advance_input(
    x: torch.Tensor,  # [B, m, E, G, V_model_in]
    y_pred: torch.Tensor,  # [B, n_out, E, G, V_model_out]
    batch_norm: torch.Tensor,  # [B, W, E, G, V_data] normalised
    time_offset: int,
    ia: Dict[str, torch.Tensor],
) -> torch.Tensor:
    """Roll the input window one model step forward: shift time, insert the
    predicted prognostics, re-read the forcings from the batch."""
    n_out = y_pred.shape[1]
    from_pred = y_pred[..., ia["from_pred"]]
    from_data = batch_norm[:, time_offset : time_offset + n_out][..., ia["from_data"]]
    new_steps = torch.where(ia["is_prog"], from_pred, from_data).to(x.dtype)
    return torch.cat([x[:, n_out:], new_steps], dim=1)


def device_index_arrays(interface) -> Dict[str, Dict[str, torch.Tensor]]:
    return {
        ds: {k: torch.as_tensor(v, device=interface.device) for k, v in _index_arrays(idx).items()}
        for ds, idx in interface.data_indices.items()
    }


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element (optax.global_norm)."""
    return torch.nn.utils.get_total_norm([t.float() for t in tensors])


def make_step_fns(
    interface,
    losses: Dict[str, Callable],
    rollout: int,
    remat_rollout: bool = False,
    remat_policy: Optional[str] = None,
    ensemble_size: int = 1,
    output_masks: Optional[dict] = None,
    precision: str = "fp32",
    fp32_head: bool = False,
    task: str = "forecaster",
    with_grad_norm: bool = True,
) -> Tuple[Callable, Callable]:
    """Build ``(train_step, eval_step)``.

    ``interface``: an ``AnemoiModelInterface`` built with ``training=True``
    (float32 master weights).  ``losses``: per-dataset loss callables
    ``(pred, target) -> scalar``.  ``precision="bf16"`` runs the model on
    bf16 compute copies of the masters (``fp32_head`` keeps the decoder's
    output head in float32); the loss is always float32.

    ``train_step(state, batch) -> (state, {"loss", "grad_norm"})`` updates
    ``state`` IN PLACE (the master weights, the optimizer state and the step
    counter) and returns it; ``grad_norm`` is the global norm of the raw
    gradients before clipping.  ``train_step.compute_gradients(state,
    batch)`` leaves the gradients in the parameters' ``.grad`` and returns
    the loss, without an update.  ``eval_step(state, batch) -> {"val_loss",
    "rmse/<ds>/<group>/<step>", ...}`` runs without gradients.
    """
    if task != "forecaster":
        raise NotImplementedError(f"task '{task}' is not ported to anemoi_tpu_torch")
    if ensemble_size != 1:
        raise NotImplementedError("ensemble training is not ported to anemoi_tpu_torch")
    if output_masks:
        raise NotImplementedError("boundary masks are not ported to anemoi_tpu_torch")
    if remat_policy is not None or (remat_rollout and rollout > 1):
        raise NotImplementedError("rollout remat is not ported to anemoi_tpu_torch")
    if precision not in COMPUTE_TYPES:
        raise ValueError(f"unknown precision '{precision}'")
    if any(p.dtype != torch.float32 for p in interface.parameters()):
        raise ValueError("make_step_fns needs float32 master weights: build the interface "
                         "with training=True")
    compute_dtype = COMPUTE_TYPES[precision]
    model = interface.model
    pre = interface.pre_processors
    m, n_out = model.n_step_input, model.n_step_output
    dataset_names = sorted(interface.data_indices)
    ia = device_index_arrays(interface)
    groups = {ds: variable_groups(idx.model.output.ordered_names)
              for ds, idx in interface.data_indices.items()}
    for loss in losses.values():
        if hasattr(loss, "to"):
            loss.to(interface.device)

    def _group_metrics(out, y_pred, batch, step, t0):
        """Denormalised per-variable-group RMSE of one rollout step."""
        for ds in dataset_names:
            y_phys = pre[ds].inverse_transform(y_pred[ds].float())
            truth = batch[ds][:, t0 : t0 + n_out][..., ia[ds]["model_out_in_data"]]
            valid = ~torch.isnan(truth) & ~torch.isnan(y_phys)
            sq = torch.where(valid, (y_phys - truth) ** 2, 0.0)
            denom = valid.sum(dim=(0, 1, 2, 3)).clamp_min(1)
            per_var_mse = sq.sum(dim=(0, 1, 2, 3)) / denom  # [V]
            for gname, idxs in groups[ds].items():
                out[f"rmse/{ds}/{gname}/{step + 1}"] = torch.sqrt(per_var_mse[idxs].mean())

    def rollout_loss(batch, with_metrics=False):
        params = (interface.cast_parameters(compute_dtype, fp32_head)
                  if compute_dtype is not None else None)
        batch_norm = {ds: pre[ds].transform(batch[ds].float()) for ds in dataset_names}
        x = {ds: batch_norm[ds][:, :m][..., ia[ds]["data_input_full"]] for ds in dataset_names}
        if compute_dtype is not None:
            x = {ds: v.to(compute_dtype) for ds, v in x.items()}
        total = 0.0
        metrics: Dict[str, torch.Tensor] = {}
        for step in range(rollout):
            y_pred = interface.run_model(x, params)
            t0 = m + step * n_out
            for ds in dataset_names:
                target = batch_norm[ds][:, t0 : t0 + n_out][..., ia[ds]["model_out_in_data"]]
                # the loss in float32 whatever the compute type
                total = total + losses[ds](y_pred[ds].float(), target)
            if with_metrics:
                _group_metrics(metrics, y_pred, batch, step, t0)
            if step + 1 < rollout:
                x = {ds: advance_input(x[ds], y_pred[ds], batch_norm[ds], t0, ia[ds])
                     for ds in dataset_names}
        loss = total / (rollout * len(dataset_names))
        return (loss, metrics) if with_metrics else loss

    def compute_gradients(state: TrainState, batch) -> torch.Tensor:
        interface.zero_grad(set_to_none=True)
        loss = rollout_loss(batch)
        loss.backward()
        return loss.detach()

    def train_step(state: TrainState, batch):
        loss = compute_gradients(state, batch)
        metrics = {"loss": loss}
        if with_grad_norm:
            metrics["grad_norm"] = global_norm(
                p.grad for p in interface.parameters() if p.grad is not None
            )
        state.apply_gradients()
        return state, metrics

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        loss, group_metrics = rollout_loss(batch, with_metrics=True)
        return {"val_loss": loss, **group_metrics}

    train_step.compute_gradients = compute_gradients
    return train_step, eval_step
