"""The training and validation step with autoregressive rollout.

Port of ``anemoi_tpu.training.step``: ``TrainState``, ``_index_arrays``,
``advance_input`` and ``make_step_fns`` for its three tasks.  The JAX
step is one jitted pure function; here the step runs eagerly and updates
the master weights and the optimizer state in place.

Batch layout (data space, un-normalised): ``{ds: [B, W, E, G, V_data]}``
with ``W = n_step_input + rollout * n_step_output``.

Rollout remat (``remat_rollout`` at ``rollout > 1``) checkpoints each
rollout step's forward under ``remat_policy`` (``None``: recompute it
whole), as the JAX step wraps it in ``jax.checkpoint``.

Ensembles (``ensemble_size > 1``, the JAX ``EnsembleTraining``): the inputs
are tiled over the member dim, the targets stay single-truth (the CRPS
loss).  An ensemble model's noise is drawn per (training step, rollout
step) from a generator seeded by :func:`fold_seed` of the base seed, as the
JAX step folds its key; the draw is made outside the rollout checkpoint and
enters it as an input, so the recompute in the backward reads the same
noise.

Tasks (the JAX step's time-offset algebra): ``forecaster`` (inputs the
first ``n_step_input`` steps, targets each rollout step's next
``n_step_output``); ``autoencoder`` (targets ``t0 = n_step_input -
n_step_output``, inside the input window); ``temporal_downscaler`` (inputs
the window's endpoints ``0`` and ``n_step_output + 1``, so ``n_step_input``
must be 2, targets the interior ``t0 = 1``).  The last two run one model
step whatever the rollout, with no rollout remat.

Limited-area models (``output_masks``, ``training/masks.py``): at each
rollout step the prognostics outside the area are re-forced from the
normalised truth (``advance_input``'s ``boundary_mask``); the loss is
masked to the area by the trainer's ``output_mask`` scaler.  An imputer's
NaN bookkeeping (``Processors.compute_aux``) is computed from the raw batch
before it is normalised: its loss mask zeroes the loss where an imputed
variable was NaN, and the validation metrics put those NaNs back.  Both
masks are step inputs that enter no rollout checkpoint.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.models.layers.remat import checkpointed, resolve_remat_policy
from anemoi_tpu_torch.training.losses.multiscale import MultiscaleLossWrapper
from anemoi_tpu_torch.training.metrics import variable_groups
from anemoi_tpu_torch.utils.seeding import context_seed, fold_seed

TASKS = ("forecaster", "autoencoder", "temporal_downscaler")
EVAL_NOISE_STEP = 2**31 - 1  # the validation's noise stream, as the JAX eval step folds it
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
    boundary_mask: Optional[torch.Tensor] = None,  # [G] True inside the area
) -> torch.Tensor:
    """Roll the input window one model step forward: shift time, insert the
    predicted prognostics, re-read the forcings from the batch.  With a
    ``boundary_mask`` (limited area), the prognostics outside the area are
    re-read from the batch too."""
    n_out = y_pred.shape[1]
    from_pred = y_pred[..., ia["from_pred"]]
    from_data = batch_norm[:, time_offset : time_offset + n_out][..., ia["from_data"]]
    use_pred = ia["is_prog"]
    if boundary_mask is not None:
        use_pred = use_pred & boundary_mask[:, None]
    new_steps = torch.where(use_pred, from_pred, from_data).to(x.dtype)
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
    remat_rollout: bool = True,
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
    output head in float32); the loss is always float32.  With
    ``remat_rollout`` and ``rollout > 1`` each rollout step's forward is
    checkpointed under ``remat_policy`` (``None`` or ``"full"``: nothing
    kept; ``"save_attention"``, ``"save_attention_mlp"``, ``"dots"``: see
    ``models/layers/remat.py``); the compute copies are cast once per step,
    outside the checkpoints, and enter them as inputs.  ``ensemble_size``
    members run per sample; the noise of an ensemble model is seeded by
    ``context_seed("ensemble-noise")``, the train step and the rollout step.
    ``output_masks``: ``{ds: Boolean1DMask}`` of the limited-area datasets,
    whose boundary is re-forced from the truth at each rollout step.

    ``train_step(state, batch) -> (state, {"loss", "grad_norm"})`` updates
    ``state`` IN PLACE (the master weights, the optimizer state and the step
    counter) and returns it; ``grad_norm`` is the global norm of the raw
    gradients before clipping.  ``train_step.compute_gradients(state,
    batch)`` leaves the gradients in the parameters' ``.grad`` and returns
    the loss, without an update.  ``eval_step(state, batch) -> {"val_loss",
    "rmse/<ds>/<group>/<step>", ...}`` runs without gradients.
    """
    if task == "transport":
        raise ValueError("the transport task trains with "
                         "training/transport_step.make_transport_step_fns")
    if task not in TASKS:
        raise NotImplementedError(f"task '{task}' is not ported to anemoi_tpu_torch")
    policy = resolve_remat_policy(remat_policy)
    # at rollout 1 there is nothing between rollout steps to free: the outer
    # checkpoint would only add a recompute (the JAX step's rule)
    remat = remat_rollout and rollout > 1 and task == "forecaster"
    # the autoencoder and the downscaler run one model step
    steps = rollout if task == "forecaster" else 1
    if precision not in COMPUTE_TYPES:
        raise ValueError(f"unknown precision '{precision}'")
    if any(p.dtype != torch.float32 for p in interface.parameters()):
        raise ValueError("make_step_fns needs float32 master weights: build the interface "
                         "with training=True")
    compute_dtype = COMPUTE_TYPES[precision]
    model = interface.model
    pre = interface.pre_processors
    m, n_out = model.n_step_input, model.n_step_output
    if task == "temporal_downscaler" and m != 2:
        raise ValueError("temporal_downscaler needs n_step_input=2 (the window's endpoints)")
    dataset_names = sorted(interface.data_indices)
    for ds in dataset_names:
        if pre[ds].has_imputer and isinstance(losses[ds], MultiscaleLossWrapper):
            # the JAX wrapper takes no imputer mask: no reference to follow
            raise ValueError(f"dataset '{ds}': MultiscaleLossWrapper with an imputer is not "
                             "supported (ROADMAP Queue 3)")
    # the input steps of the window, and each model step's first target step
    inputs = [0, n_out + 1] if task == "temporal_downscaler" else list(range(m))
    first_target = {"forecaster": lambda step: m + step * n_out,
                    "autoencoder": lambda step: m - n_out,
                    "temporal_downscaler": lambda step: 1}[task]
    ia = device_index_arrays(interface)
    groups = {ds: variable_groups(idx.model.output.ordered_names)
              for ds, idx in interface.data_indices.items()}
    for loss in losses.values():
        if hasattr(loss, "to"):
            loss.to(interface.device)
    noise_seed = context_seed("ensemble-noise")
    boundary = {ds: output_masks[ds].as_tensor(interface.device)
                if output_masks and ds in output_masks else None for ds in dataset_names}

    def noise_for(x, noise_step: int, step: int):
        """An ensemble model's noise for one rollout step, or None."""
        if not interface.draws_noise:
            return None
        gen = torch.Generator(device=interface.device).manual_seed(
            fold_seed(noise_seed, noise_step, step))
        return interface.draw_noise(x, gen)

    def forward(x, params, noise, fcstep):
        return interface.run_model(x, params, noise=noise, fcstep=fcstep)

    def _group_metrics(out, y_pred, batch, step, t0, pre_aux):
        """Denormalised per-variable-group RMSE of one rollout step."""
        for ds in dataset_names:
            y_phys = pre[ds].inverse_transform(y_pred[ds].float(), aux=pre_aux[ds])
            truth = batch[ds][:, t0 : t0 + n_out][..., ia[ds]["model_out_in_data"]]
            valid = ~torch.isnan(truth) & ~torch.isnan(y_phys)
            sq = torch.where(valid, (y_phys - truth) ** 2, 0.0)
            denom = valid.sum(dim=(0, 1, 2, 3)).clamp_min(1)
            per_var_mse = sq.sum(dim=(0, 1, 2, 3)) / denom  # [V]
            for gname, idxs in groups[ds].items():
                out[f"rmse/{ds}/{gname}/{step + 1}"] = torch.sqrt(per_var_mse[idxs].mean())

    def rollout_loss(batch, noise_step: int, with_metrics=False):
        params = (interface.cast_parameters(compute_dtype, fp32_head)
                  if compute_dtype is not None else None)
        # the imputer's NaN bookkeeping, from the raw batch
        pre_aux = {ds: pre[ds].compute_aux(batch[ds]) for ds in dataset_names}
        loss_masks = {ds: pre[ds].loss_mask(pre_aux[ds]) for ds in dataset_names}
        batch_norm = {ds: pre[ds].transform(batch[ds].float()) for ds in dataset_names}
        x = {ds: batch_norm[ds][:, inputs][..., ia[ds]["data_input_full"]]
             for ds in dataset_names}
        if compute_dtype is not None:
            x = {ds: v.to(compute_dtype) for ds, v in x.items()}
        if ensemble_size > 1:
            # every member starts from the same state; the noise spreads them
            x = {ds: v.expand(v.shape[:2] + (ensemble_size,) + v.shape[3:])
                 for ds, v in x.items()}
        total = 0.0
        metrics: Dict[str, torch.Tensor] = {}
        for step in range(steps):
            noise = noise_for(x, noise_step, step)
            if remat and torch.is_grad_enabled():
                y_pred = checkpointed(forward, policy, x, params, noise, step)
            else:
                y_pred = forward(x, params, noise, step)
            t0 = first_target(step)
            for ds in dataset_names:
                target = batch_norm[ds][:, t0 : t0 + n_out][..., ia[ds]["model_out_in_data"]]
                # the loss in float32 whatever the compute type
                total = total + losses[ds](y_pred[ds].float(), target, mask=loss_masks[ds])
            if with_metrics:
                _group_metrics(metrics, y_pred, batch, step, t0, pre_aux)
            if step + 1 < steps:
                x = {ds: advance_input(x[ds], y_pred[ds], batch_norm[ds], t0, ia[ds],
                                       boundary_mask=boundary[ds])
                     for ds in dataset_names}
        loss = total / (steps * len(dataset_names))
        return (loss, metrics) if with_metrics else loss

    def compute_gradients(state: TrainState, batch) -> torch.Tensor:
        interface.zero_grad(set_to_none=True)
        loss = rollout_loss(batch, state.step)
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
        loss, group_metrics = rollout_loss(batch, EVAL_NOISE_STEP, with_metrics=True)
        return {"val_loss": loss, **group_metrics}

    train_step.compute_gradients = compute_gradients
    return train_step, eval_step
