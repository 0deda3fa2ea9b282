"""Inference: autoregressive forecasting.

Port of ``anemoi_tpu.inference.make_forecast_fn``: given a raw data-space
window holding the initial conditions and the future forcings, roll the
model forward ``steps`` times and return denormalised model-space forecasts.
The rollout helpers (``advance_input``) are the port's
``training/step.py``.  An interface that holds float32 training weights
serves on copies cast to its serving type.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from anemoi_tpu_torch.training.step import advance_input, device_index_arrays


def make_forecast_fn(interface, steps: int) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """fn(batch) -> {ds: [B, steps*n_out, E, G, V_out]} physical, float32.

    batch: raw data-space {ds: [B, m + steps*n_out, E, G, V_data]} on the
    interface's device -- the window beyond the first m steps supplies the
    future forcings."""
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
            y_pred = interface.run_model(x, params)
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
