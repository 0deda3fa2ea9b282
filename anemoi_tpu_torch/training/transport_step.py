"""Transport (diffusion / interpolant) training steps and the sampler.

Port of ``anemoi_tpu.training.transport_step``: ``make_transport_step_fns``
(one EDM or stochastic-interpolant training step: draw the noise level and
the noise, run the model on the noised target, score the denoiser or the
velocity) and ``make_sampler`` (generation conditioned on the input window,
an ODE sampler over a host schedule).

Noise: each dataset's draws in a training step come from a
``torch.Generator`` seeded ``fold_seed(base seed, step, dataset index)``
(base seed ``context_seed("transport-noise")``), the validation's from
``fold_seed(base seed, 2**31 - 1, dataset index)``, as the JAX step folds
its key; the sampler draws its initial state from the generator it is
given.  The streams are torch's, not JAX's threefry: the same
distributions, not the same draws.

Precision: ``precision="bf16"`` (the JAX '16-mixed') runs the model on
bfloat16 copies of the float32 master weights, with bfloat16 inputs and
noised target; the noise math and the loss stay float32.  The sampler
integrates in float32 and runs the model in the interface's serving type.

Data and model parallelism (JAX ``tests/test_model_parallel.py:361``): each
rank trains on its batch rows and, under model shards (``edges`` or
``heads``), its grid rows; every draw is the one-process draw of the
global batch and the whole grid, cut to the rank's block
(``random_fields.DrawShard``), so a step equals one process's at the same
global batch; the loss is each rank's grid share and the gradients and
losses are reduced as in ``training/step.py``.  The sampler on a model
group draws its initial state the same way and runs on the rank's rows
(``inference.make_transport_forecast_fn`` gathers the grid).

The ensemble axis (``hardware.num_devices_per_ensemble`` E > 1): a
transport model has no members to split, so the ranks of an ensemble group
are replicas.  They read the same batch rows and grid block, draw the same
noise (the draws are seeded by the step and cut by data and model index
alone) and reduce the loss and gradients over the model and data groups
only, so every replica takes the one-process step and their parameters stay
equal (summing over the ensemble group too would give E times the
gradient).

One dataset only: the JAX model takes ``y_noised`` for every dataset while
the JAX step passes one, so a multi-dataset transport config fails there
with a ``KeyError``; here both functions refuse it with a ``ValueError``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch

from anemoi_tpu_torch.models.transport import random_fields
from anemoi_tpu_torch.models.transport.objectives import (
    EDMConfig,
    edm_denoise,
    edm_preconditioning,
    edm_training_targets,
    interpolant_training_targets,
)
from anemoi_tpu_torch.models.transport.samplers import SAMPLERS
from anemoi_tpu_torch.models.transport.schedules import karras_sigma_schedule, unit_time_schedule
from anemoi_tpu_torch.models.transport.sources import SourceSpec, build_sources
from anemoi_tpu_torch.training.step import (
    COMPUTE_TYPES,
    EVAL_NOISE_STEP,
    TrainState,
    device_index_arrays,
    global_norm,
    mean_loss_over_ranks,
    rank_groups,
    reduce_gradients,
)
from anemoi_tpu_torch.utils.seeding import context_seed, fold_seed

OBJECTIVES = ("edm", "interpolant")


def _one_dataset(interface, what: str) -> str:
    names = sorted(interface.data_indices)
    if len(names) != 1:
        raise ValueError(
            f"{what}: transport models train and sample one dataset; got {names}. The JAX "
            "model takes the noised target of every dataset while its step passes one, so "
            "the JAX package fails on such a config with a KeyError")
    if not interface.is_transport:
        raise ValueError(f"{what} needs a transport model, not {type(interface.model).__name__}")
    return names[0]


def make_transport_step_fns(
    interface,
    losses: Dict[str, Callable],
    objective: str = "edm",
    edm: EDMConfig = EDMConfig(),
    tendency: bool = False,
    interpolant_gamma: float = 0.0,
    source: str = "gaussian",
    sigma_dist: Optional[dict] = None,
    beta_schedule: str = "linear",
    sigma_schedule: str = "brownian_bridge",
    precision: str = "fp32",
) -> Tuple[Callable, Callable]:
    """``(train_step, eval_step)`` of transport training, as
    ``training/step.make_step_fns`` returns them: ``train_step(state,
    batch) -> (state, {"loss", "grad_norm"})`` updates ``state`` in place
    (``train_step.compute_gradients`` leaves the gradients in ``.grad``);
    ``eval_step(state, batch) -> {"val_loss"}``.

    ``objective``: ``edm`` (denoiser, sigma from ``sigma_dist``, the kwargs
    of ``schedules.sample_training_sigma_dist``, default EDM's log-normal)
    or ``interpolant`` (velocity from the ``source`` field, ``zero``,
    ``gaussian`` or ``reference_state``, to the target along
    ``beta_schedule``/``sigma_schedule`` with bridge noise
    ``interpolant_gamma``).  ``tendency``: the target is the increment over
    the last input state.  Raises ``ValueError`` for more than one dataset.
    On a mesh with an ensemble group the group's ranks are replicas: the
    gradients are reduced over the model and data groups only."""
    ds = _one_dataset(interface, "make_transport_step_fns")
    if objective not in OBJECTIVES:
        raise ValueError(f"Unknown transport objective '{objective}'")
    if precision not in COMPUTE_TYPES:
        raise ValueError(f"unknown precision '{precision}'")
    if any(p.dtype != torch.float32 for p in interface.parameters()):
        raise ValueError("make_transport_step_fns needs float32 master weights: build the "
                         "interface with training=True")
    compute_dtype = COMPUTE_TYPES[precision]
    model = interface.model
    pre = interface.pre_processors[ds]
    indices = interface.data_indices
    m, n_out = model.n_step_input, model.n_step_output
    ia = device_index_arrays(interface)[ds]
    loss = losses[ds]
    if hasattr(loss, "to"):
        loss.to(interface.device)
    base_seed = context_seed("transport-noise")
    model_group = rank_groups(interface)[0]
    if model_group is not None:
        # each rank scores its grid rows
        from anemoi_tpu_torch.training.losses.base import grid_sharded

        loss = grid_sharded(loss, model.grid_rows(ds), model.graph.num_nodes[ds], model_group)
    # the one-process draws of the global batch and grid, cut to the rank's block
    shard = interface.draw_shard(ds, batch_sharded=True)

    def cast(v: torch.Tensor) -> torch.Tensor:
        return v if compute_dtype is None else v.to(compute_dtype)

    def transport_loss(batch, noise_step: int) -> torch.Tensor:
        params = (interface.cast_parameters(compute_dtype) if compute_dtype is not None
                  else None)
        batch = interface.local_rows(batch)
        batch_norm = pre.transform(batch[ds].float())
        x_in = batch_norm[:, :m][..., ia["data_input_full"]]
        target = batch_norm[:, m : m + n_out][..., ia["model_out_in_data"]]
        if tendency:
            target = target - batch_norm[:, m - 1 : m - 1 + n_out][..., ia["model_out_in_data"]]
        x = {ds: cast(x_in)}
        gen = torch.Generator(device=interface.device).manual_seed(
            fold_seed(base_seed, noise_step, 0))
        if objective == "edm":
            y_noised, sigma, weight = edm_training_targets(gen, target, edm, sigma_dist,
                                                           shard=shard)
            _, _, c_in, c_noise = edm_preconditioning(sigma, edm.sigma_data)
            f_out = interface.run_model(x, params, y_noised={ds: cast(c_in * y_noised)},
                                        noise_level=c_noise[:, 0, :, 0, 0])
            d = edm_denoise(f_out[ds].float(), y_noised, sigma, edm)
            return loss(torch.sqrt(weight) * d, torch.sqrt(weight) * target)
        y0 = build_sources(source, gen, {ds: SourceSpec.from_tensor(target)}, x={ds: x_in},
                           data_indices=indices, n_step_output=n_out, shard=shard)[ds]
        x_t, t, velocity = interpolant_training_targets(
            gen, y0, target, interpolant_gamma, beta_schedule=beta_schedule,
            sigma_schedule=sigma_schedule, shard=shard)
        f_out = interface.run_model(x, params, y_noised={ds: cast(x_t)},
                                    noise_level=t[:, 0, :, 0, 0])
        return loss(f_out[ds].float(), velocity)

    def compute_gradients(state: TrainState, batch) -> torch.Tensor:
        interface.zero_grad(set_to_none=True)
        value = transport_loss(batch, state.step)
        value.backward()
        reduce_gradients(interface.parameters(), interface, over_ensemble=False)
        return mean_loss_over_ranks(value.detach(), interface)

    def train_step(state: TrainState, batch):
        value = compute_gradients(state, batch)
        grad_norm = global_norm(p.grad for p in interface.parameters() if p.grad is not None)
        state.apply_gradients()
        return state, {"loss": value, "grad_norm": grad_norm}

    @torch.no_grad()
    def eval_step(state: TrainState, batch):
        return {"val_loss": mean_loss_over_ranks(transport_loss(batch, EVAL_NOISE_STEP),
                                                 interface)}

    train_step.compute_gradients = compute_gradients
    return train_step, eval_step


def make_sampler(
    interface,
    objective: str = "edm",
    sampler: str = "edm_heun",
    num_steps: int = 20,
    edm: EDMConfig = EDMConfig(),
) -> Callable:
    """``generate(x, generator) -> {ds: [B, T_out, E, G, V_out]}`` (float32,
    normalised model space): one sample conditioned on the normalised
    model-space window ``x = {ds: [B, T_in, E, G, V_in]}``, its initial
    state (EDM: ``N(0, sigma_max^2)``; interpolant: ``N(0, 1)``) drawn from
    ``generator``.  The schedule (Karras's sigmas between ``edm.sigma_min``
    and ``edm.sigma_max`` for EDM, the unit-time grid for the interpolant)
    lives on the host.  The model runs
    in the interface's serving type, on copies cast once per call when the
    interface holds float32 training weights; the integration stays float32.
    Raises ``ValueError`` for more than one dataset."""
    ds = _one_dataset(interface, "make_sampler")
    if objective not in OBJECTIVES:
        raise ValueError(f"Unknown transport objective '{objective}'")
    if sampler not in SAMPLERS:
        raise ValueError(f"Unknown transport sampler '{sampler}'; expected one of "
                         f"{sorted(SAMPLERS)}")
    model = interface.model
    n_out = model.n_step_output
    v_out = interface.data_indices[ds].num_model_output_vars
    if objective == "edm":
        grid = karras_sigma_schedule(num_steps, edm.sigma_min, edm.sigma_max)
    else:
        grid = unit_time_schedule(num_steps)
    sample_fn = SAMPLERS[sampler]
    dt = interface.inference_dtype
    cast = interface.param_dtype != dt
    shard = interface.draw_shard(ds)  # under model shards: the rank's grid rows

    @torch.no_grad()
    def generate(x: Dict[str, torch.Tensor], generator: torch.Generator):
        params = interface.cast_parameters(dt) if cast else None
        xc = {k: v.to(dt) for k, v in x.items()}
        b, _, e, g = x[ds].shape[:4]
        shape = (b, n_out, e, g, v_out)
        device = x[ds].device

        if objective == "edm":
            def denoise_fn(y, sigma: float):
                sig = torch.full((b, 1, e, 1, 1), sigma, dtype=torch.float32, device=device)
                _, _, c_in, c_noise = edm_preconditioning(sig, edm.sigma_data)
                f = interface.run_model(xc, params, y_noised={ds: (c_in * y).to(dt)},
                                        noise_level=c_noise[:, 0, :, 0, 0])
                return edm_denoise(f[ds].float(), y, sig, edm)

            y0 = random_fields.sharded_normal(generator, shape, shard=shard) * float(grid[0])
            return {ds: sample_fn(denoise_fn, y0, grid)}

        def velocity_fn(xt, t: float):
            level = torch.full((b, e), t, dtype=torch.float32, device=device)
            f = interface.run_model(xc, params, y_noised={ds: xt.to(dt)}, noise_level=level)
            return f[ds].float()

        y0 = random_fields.sharded_normal(generator, shape, shard=shard)
        return {ds: sample_fn(velocity_fn, y0, grid)}

    generate.schedule = grid
    return generate
