"""Inference: autoregressive forecasting.

Port of ``anemoi_tpu.inference.make_forecast_fn``: given a raw data-space
window holding the initial conditions and the future forcings, roll the
model forward ``steps`` times and return denormalised model-space forecasts.
``_index_arrays`` and ``advance_input`` are the port's own copies of the
rollout helpers of ``anemoi_tpu.training.step``.
"""

from __future__ import annotations

from typing import Callable, Dict

import numpy as np
import torch

from anemoi_tpu_torch.data_indices.collection import IndexCollection


def _index_arrays(idx: IndexCollection) -> Dict[str, np.ndarray]:
    """Per model-INPUT variable j: prognostic ones come from the prediction
    (``from_pred[j]``), forcings from the batch at the new time
    (``from_data[j]``)."""
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
    return {
        "data_input_full": np.asarray(idx.data.input.full, dtype=np.int64),
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


def make_forecast_fn(interface, steps: int) -> Callable[[Dict[str, torch.Tensor]], Dict]:
    """fn(batch) -> {ds: [B, steps*n_out, E, G, V_out]} physical, float32.

    batch: raw data-space {ds: [B, m + steps*n_out, E, G, V_data]} on the
    interface's device -- the window beyond the first m steps supplies the
    future forcings."""
    model = interface.model
    pre = interface.pre_processors
    m, n_out = model.n_step_input, model.n_step_output
    dataset_names = sorted(interface.data_indices)
    ia = {
        ds: {k: torch.as_tensor(v, device=interface.device) for k, v in _index_arrays(idx).items()}
        for ds, idx in interface.data_indices.items()
    }

    @torch.no_grad()
    def forecast(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch_norm, x = interface.normalised_input(batch)
        outputs = {ds: [] for ds in dataset_names}
        for step in range(steps):
            y_pred = model(x)
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
