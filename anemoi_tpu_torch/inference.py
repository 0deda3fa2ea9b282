"""Inference: autoregressive forecasting.

Port of ``anemoi_tpu.inference``: ``make_forecast_fn`` (given a raw
data-space window holding the initial conditions and the future forcings,
roll the model forward ``steps`` times and return denormalised model-space
forecasts; the rollout helpers are the port's ``training/step.py``; an
interface that holds float32 training weights serves on copies cast to its
serving type), ``make_transport_forecast_fn`` (the generative forecast of a
transport model: each step sampled by ``training/transport_step.make_sampler``
conditioned on the window) and ``run_forecast_cli``, the ``predict``
command, which serves both (a transport bundle with the objective, sampler,
sampling steps, tendency and EDM settings of its ``training.transport``
config, its noise drawn from a generator seeded with ``--seed``).

An ensemble model that draws noise is served by
``AnemoiModelInterface.predict_step`` (or ``apply``), not here: the JAX
``make_forecast_fn`` runs its model with no noise stream and fails on one,
so ``make_forecast_fn`` refuses it
(``AnemoiModelInterface.require_deterministic``) and ``predict``
returns 1.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Dict

import numpy as np
import torch

from anemoi_tpu_torch.models.transport.objectives import EDMConfig
from anemoi_tpu_torch.training.step import advance_input, device_index_arrays
from anemoi_tpu_torch.utils.tracing import span


def make_forecast_fn(interface, steps: int) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """fn(batch) -> {ds: [B, steps*n_out, E, G, V_out]} physical, float32.

    batch: raw data-space {ds: [B, m + steps*n_out, E, G, V_data]} on the
    interface's device -- the window beyond the first m steps supplies the
    future forcings.  Raises ``ValueError`` for a model that draws noise.
    Under model shards every rank of the model group runs its grid rows
    (of a whole-grid or a local batch) and returns the whole forecast,
    gathered over the group.  A forecast is the profiler's span
    ``anemoi.forecast``, its phases the spans
    ``anemoi.forecast.{inputs,cast,model,output,advance,gather}`` inside it
    (``utils/tracing.py``)."""
    interface.require_deterministic("make_forecast_fn")
    model = interface.model
    pre = interface.pre_processors
    m, n_out = model.n_step_input, model.n_step_output
    dataset_names = sorted(interface.data_indices)
    ia = device_index_arrays(interface)
    cast = interface.param_dtype != interface.inference_dtype

    @torch.no_grad()
    def forecast(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with span("anemoi.forecast"):
            return rollout(batch)

    def rollout(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        with span("anemoi.forecast.inputs"):
            batch_norm, x = interface.normalised_input(interface.local_rows(batch))
        params = None
        if cast:
            with span("anemoi.forecast.cast"):
                params = interface.cast_parameters(interface.inference_dtype)
        outputs = {ds: [] for ds in dataset_names}
        for step in range(steps):
            lead = {"step": step}
            with span("anemoi.forecast.model", lead):
                y_pred = interface.run_model(x, params, fcstep=step)
            t0 = m + step * n_out
            with span("anemoi.forecast.output", lead):
                for ds in dataset_names:
                    outputs[ds].append(pre[ds].inverse_transform(y_pred[ds].float()))
            if step + 1 < steps:
                with span("anemoi.forecast.advance", lead):
                    x = {
                        ds: advance_input(x[ds], y_pred[ds], batch_norm[ds], t0, ia[ds])
                        for ds in dataset_names
                    }
        with span("anemoi.forecast.gather"):
            return interface.gather_grid({ds: torch.cat(v, dim=1)
                                          for ds, v in outputs.items()})

    return forecast


def make_transport_forecast_fn(interface, steps: int, objective: str = "edm",
                               sampler: str = "edm_heun", num_steps: int = 20,
                               tendency: bool = False, edm: EDMConfig = EDMConfig()) -> Callable:
    """fn(batch, generator) -> {ds: [B, steps*n_out, E, G, V_out]} physical,
    float32: per step, sample the next state conditioned on the window
    (``num_steps`` steps of ``sampler``, EDM's preconditioning and sigma
    range from ``edm``; the initial states drawn from ``generator`` in
    turn), add the last state to it for a ``tendency`` model, denormalise
    it and advance the window.  ``batch`` as for :func:`make_forecast_fn`;
    on a model group every rank samples its grid rows (each initial state
    the one-process draw's block) and returns the whole forecast."""
    from anemoi_tpu_torch.training.transport_step import make_sampler

    generate = make_sampler(interface, objective=objective, sampler=sampler,
                            num_steps=num_steps, edm=edm)
    model = interface.model
    pre = interface.pre_processors
    m, n_out = model.n_step_input, model.n_step_output
    dataset_names = sorted(interface.data_indices)
    ia = device_index_arrays(interface)

    @torch.no_grad()
    def forecast(batch: Dict[str, torch.Tensor], generator: torch.Generator):
        batch = interface.local_rows(batch)
        batch_norm = {ds: pre[ds].transform(batch[ds].float()) for ds in dataset_names}
        x = {ds: batch_norm[ds][:, :m][..., ia[ds]["data_input_full"]] for ds in dataset_names}
        # a tendency model samples the increment over the last state
        prev = {ds: batch_norm[ds][:, m - 1 : m - 1 + n_out][..., ia[ds]["model_out_in_data"]]
                for ds in dataset_names}
        outputs = {ds: [] for ds in dataset_names}
        for step in range(steps):
            y = generate(x, generator)
            if tendency:
                y = {ds: prev[ds] + y[ds] for ds in dataset_names}
            prev = y
            t0 = m + step * n_out
            for ds in dataset_names:
                outputs[ds].append(pre[ds].inverse_transform(y[ds]))
            if step + 1 < steps:
                x = {ds: advance_input(x[ds], y[ds], batch_norm[ds], t0, ia[ds])
                     for ds in dataset_names}
        return interface.gather_grid({ds: torch.cat(v, dim=1) for ds, v in outputs.items()})

    forecast.schedule = generate.schedule
    return forecast


def transport_settings(config: dict) -> dict:
    """The ``make_transport_forecast_fn`` keywords of a bundle's config
    (its ``training.transport``), with the JAX ``run_forecast_cli``'s
    defaults.  Unlike that function, it also reads the ``edm`` mapping the
    model was trained with, so a bundle with a non-default ``sigma_data``
    or sigma range is sampled with the preconditioning it learnt."""
    tcfg = dict(((config or {}).get("training") or {}).get("transport") or {})
    objective = str(tcfg.get("objective", "edm"))
    return {
        "objective": objective,
        "sampler": str(tcfg.get("sampler", "edm_heun" if objective == "edm" else "vf_heun")),
        "num_steps": int(tcfg.get("sampling_steps", 20)),
        "tendency": bool(tcfg.get("tendency", False)),
        "edm": EDMConfig.from_config(tcfg.get("edm")),
    }


def run_forecast_cli(args) -> int:
    """``predict``: load the inference bundle ``args.checkpoint`` (the
    port's or the JAX package's) on the card, or on the CPU with
    ``args.platform == "cpu"``; read the window of ``m + steps * n_out``
    times from ``args.start_index`` of the datasets of ``args.config`` (a
    YAML or JSON config, composed with the packaged presets on its search
    path) or, without it, of the bundle's own config; forecast
    ``args.steps`` steps and write ``<ds>|forecast`` ``[1, steps * n_out, E,
    G, V_out]`` and ``<ds>|variables`` to the ``.npz`` ``args.output``.
    ``args.aot_cache`` is accepted and has no effect (nothing is compiled
    ahead).  A transport bundle is sampled (:func:`transport_settings`), its
    noise from a generator on the serving device seeded with ``args.seed``."""
    from anemoi_tpu_torch.data.dataset import open_dataset
    from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config

    platform = getattr(args, "platform", None)
    if platform not in (None, "cpu", "gpu", "cuda"):
        raise ValueError(f"--platform {platform}: anemoi_tpu_torch serves on cpu or gpu")
    device = "cpu" if platform == "cpu" else None
    from anemoi_tpu_torch.parallel.distributed import maybe_initialize

    launch, mesh = maybe_initialize(platform), None
    if launch is not None and launch.world > 1:
        # the ranks of a launcher serve the bundle over one model group
        from anemoi_tpu_torch.parallel.mesh import MeshSpec, create_mesh

        device = launch.device
        mesh = create_mesh(MeshSpec(model=launch.world), device)
    iface = load_inference_checkpoint(args.checkpoint, device=device, mesh=mesh)
    steps = args.steps
    try:
        if iface.is_transport:
            sample = make_transport_forecast_fn(iface, steps, **transport_settings(iface.config))
            generator = torch.Generator(device=iface.device).manual_seed(
                int(getattr(args, "seed", 0) or 0))

            def forecast(batch):
                return sample(batch, generator)
        else:
            forecast = make_forecast_fn(iface, steps)
    except ValueError as err:
        print(f"predict: {err}")
        return 1

    cfg = load_config(args.config, search_paths=[PACKAGED_CONFIG_DIR]) if args.config else {}
    data_cfg = cfg.get("data", {})
    if not data_cfg.get("datasets"):
        data_cfg = (iface.config or {}).get("data", {})
    datasets = {name: open_dataset(ds_cfg) for name, ds_cfg in data_cfg.get("datasets", {}).items()}
    if not datasets:
        raise ValueError("predict needs data.datasets for initial conditions: pass --config "
                         "or use a bundle whose config defines them")
    window = iface.model.n_step_input + steps * iface.model.n_step_output
    batch = {
        name: torch.from_numpy(ds.get_window(args.start_index, window)[None]).to(iface.device)
        for name, ds in datasets.items()
    }
    t0 = time.perf_counter()
    out = forecast(batch)
    if iface.device.type == "cuda":
        torch.cuda.synchronize(iface.device)
    ms_per_step = (time.perf_counter() - t0) * 1e3 / steps
    if mesh is not None and not mesh.is_root:
        return 0  # rank 0 writes the forecast
    arrays = {}
    for ds_name, arr in out.items():
        arrays[f"{ds_name}|forecast"] = arr.cpu().numpy()
        arrays[f"{ds_name}|variables"] = np.asarray(
            iface.data_indices[ds_name].model.output.ordered_names)
    os.makedirs(os.path.dirname(os.path.abspath(args.output)), exist_ok=True)
    np.savez_compressed(args.output, **arrays)
    shapes = {k: tuple(v.shape) for k, v in out.items()}
    print(f"forecast written to {args.output}: {shapes} ({ms_per_step:.3f} ms a step, "
          f"one call on {iface.device})")
    return 0
