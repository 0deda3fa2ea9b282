"""Inference: autoregressive forecasting.

Port of ``anemoi_tpu.inference``: ``make_forecast_fn`` (given a raw
data-space window holding the initial conditions and the future forcings,
roll the model forward ``steps`` times and return denormalised model-space
forecasts; the rollout helpers are the port's ``training/step.py``; an
interface that holds float32 training weights serves on copies cast to its
serving type) and ``run_forecast_cli``, the ``predict`` command.  The
generative forecasts of transport models are not ported.

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

from anemoi_tpu_torch.training.step import advance_input, device_index_arrays


def make_forecast_fn(interface, steps: int) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """fn(batch) -> {ds: [B, steps*n_out, E, G, V_out]} physical, float32.

    batch: raw data-space {ds: [B, m + steps*n_out, E, G, V_data]} on the
    interface's device -- the window beyond the first m steps supplies the
    future forcings.  Raises ``ValueError`` for a model that draws noise."""
    interface.require_deterministic("make_forecast_fn")
    model = interface.model
    pre = interface.pre_processors
    m, n_out = model.n_step_input, model.n_step_output
    dataset_names = sorted(interface.data_indices)
    ia = device_index_arrays(interface)
    cast = interface.param_dtype != interface.inference_dtype

    @torch.no_grad()
    def forecast(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch_norm, x = interface.normalised_input(batch)
        params = interface.cast_parameters(interface.inference_dtype) if cast else None
        outputs = {ds: [] for ds in dataset_names}
        for step in range(steps):
            y_pred = interface.run_model(x, params, fcstep=step)
            t0 = m + step * n_out
            for ds in dataset_names:
                outputs[ds].append(pre[ds].inverse_transform(y_pred[ds].float()))
            if step + 1 < steps:
                x = {
                    ds: advance_input(x[ds], y_pred[ds], batch_norm[ds], t0, ia[ds])
                    for ds in dataset_names
                }
        return {ds: torch.cat(v, dim=1) for ds, v in outputs.items()}

    return forecast


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
    ahead)."""
    from anemoi_tpu_torch.data.dataset import open_dataset
    from anemoi_tpu_torch.training.checkpoint import load_inference_checkpoint
    from anemoi_tpu_torch.utils.config import PACKAGED_CONFIG_DIR, load_config

    platform = getattr(args, "platform", None)
    if platform not in (None, "cpu", "gpu", "cuda"):
        raise ValueError(f"--platform {platform}: anemoi_tpu_torch serves on cpu or gpu")
    device = "cpu" if platform == "cpu" else None
    iface = load_inference_checkpoint(args.checkpoint, device=device)
    model_name = str((iface.config or {}).get("model", {}).get("name", ""))
    if model_name.startswith("AnemoiTransport"):
        raise NotImplementedError("transport (generative) forecasts are not ported to "
                                  "anemoi_tpu_torch")
    steps = args.steps
    try:
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
