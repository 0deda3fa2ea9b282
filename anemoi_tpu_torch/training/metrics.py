"""Validation metrics in physical units.

Port of ``anemoi_tpu.training.metrics``: ``variable_groups`` (model-output
variables grouped per parameter for levelled variables, ``t`` for
``t_850``, ``t_500``, ..., and ``sfc`` for the rest; ``eval_step`` reports
the RMSE of each group as ``rmse/<dataset>/<group>/<step>``) and
``make_rollout_eval_fn``, the extended-rollout evaluation of the
``RolloutEvalCallback``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Tuple

import torch

from anemoi_tpu_torch.utils.variables_metadata import crack_variable_name


def variable_groups(names: List[str]) -> Dict[str, List[int]]:
    groups: Dict[str, List[int]] = {}
    for i, name in enumerate(names):
        param, level = crack_variable_name(name)
        groups.setdefault(param if level is not None else "sfc", []).append(i)
    return groups


def make_rollout_eval_fn(
    interface,
    rollout: int,
    metrics: Tuple[str, ...] = ("rmse",),
    per_timestep: bool = False,
) -> Callable[[Dict[str, torch.Tensor]], Dict[str, torch.Tensor]]:
    """``fn(batch) -> {metric_name: scalar tensor}``: an autoregressive
    rollout of ``rollout`` steps without gradients, every step scored in
    physical units (``<metric>/<ds>/<group>/<step>`` for ``rmse``/``mse``).
    The model runs with the interface's own parameters (the float32 masters
    of a training interface), as the JAX function runs with the parameters
    it is given.

    ``per_timestep=True`` also breaks the first rollout step down along the
    model's output-time dimension (``<metric>/<ds>/<group>/t_<k>``) when the
    model predicts several steps at once.  ``batch``: raw data-space
    ``{ds: [B, m + rollout * n_out, E, G, V_data]}`` on the interface's
    device.  Raises ``ValueError`` for a model that draws noise, which the
    JAX function runs with no noise stream and fails on.  On a parallel
    interface every rank scores its rows and the sums are reduced over the
    model and data groups (collective)."""
    from anemoi_tpu_torch.training.step import advance_input, device_index_arrays, sum_over_ranks

    interface.require_deterministic("make_rollout_eval_fn")
    model = interface.model
    pre = interface.pre_processors
    m, n_out = model.n_step_input, model.n_step_output
    dataset_names = sorted(interface.data_indices)
    ia = device_index_arrays(interface)
    groups = {ds: variable_groups(idx.model.output.ordered_names)
              for ds, idx in interface.data_indices.items()}

    @torch.no_grad()
    def rollout_eval(batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        batch = interface.local_rows(batch)
        batch_norm = {ds: pre[ds].transform(batch[ds].float()) for ds in dataset_names}
        x = {ds: batch_norm[ds][:, :m][..., ia[ds]["data_input_full"]] for ds in dataset_names}
        out: Dict[str, torch.Tensor] = {}
        for step in range(rollout):
            y_pred = interface.run_model(x)
            t0 = m + step * n_out
            for ds in dataset_names:
                y_phys = pre[ds].inverse_transform(y_pred[ds].float())
                truth = batch[ds][:, t0 : t0 + n_out][..., ia[ds]["model_out_in_data"]].float()
                valid = ~torch.isnan(truth)
                sq = torch.where(valid, (y_phys - truth) ** 2, 0.0)
                count = sum_over_ranks(valid.sum(dim=(0, 1, 2, 3)), interface)
                per_var_mse = sum_over_ranks(sq.sum(dim=(0, 1, 2, 3)), interface) / count.clamp_min(1)
                if per_timestep and step == 0 and n_out > 1:
                    mse_tv = (sum_over_ranks(sq.sum(dim=(0, 2, 3)), interface)
                              / sum_over_ranks(valid.sum(dim=(0, 2, 3)), interface).clamp_min(1))
                    for gname, idxs in groups[ds].items():
                        g_tv = mse_tv[:, idxs].mean(dim=1)
                        for t in range(n_out):
                            if "rmse" in metrics:
                                out[f"rmse/{ds}/{gname}/t_{t + 1}"] = torch.sqrt(g_tv[t])
                            if "mse" in metrics:
                                out[f"mse/{ds}/{gname}/t_{t + 1}"] = g_tv[t]
                for gname, idxs in groups[ds].items():
                    g_mse = per_var_mse[idxs].mean()
                    if "rmse" in metrics:
                        out[f"rmse/{ds}/{gname}/{step + 1}"] = torch.sqrt(g_mse)
                    if "mse" in metrics:
                        out[f"mse/{ds}/{gname}/{step + 1}"] = g_mse
            if step + 1 < rollout:
                x = {ds: advance_input(x[ds], y_pred[ds], batch_norm[ds], t0, ia[ds])
                     for ds in dataset_names}
        return out

    return rollout_eval
