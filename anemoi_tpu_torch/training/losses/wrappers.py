"""Loss wrappers: variable filtering and time aggregation.

Port of ``anemoi_tpu.training.losses.wrappers``: ``LossVariableMapper``
scores a subset of the variables (or one variable against another), with
the wrapped loss's variable scalers filtered to that subset once, when it
is built; ``TimeAggregateLossWrapper`` scores time differences or time
aggregates (mean, min, max) of the window.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch

from anemoi_tpu_torch.training.losses.base import BaseLoss, ScaleTensor, register_loss

#: the index spaces a tensor's trailing variable axis may be laid out in
LAYOUTS = ("model_output", "data_output", "data_full")


def _layout_table(data_indices, layout: str) -> dict:
    if layout == "model_output":
        return data_indices.model.output.name_to_position
    if layout == "data_output":
        return data_indices.data.output.name_to_position
    if layout == "data_full":
        return data_indices.data_full_name_to_position
    raise ValueError(f"Invalid layout '{layout}'. Expected one of {LAYOUTS}")


class _Wrapper(BaseLoss):
    """A loss around another one (``self.loss``), which holds the scalers."""

    def __init__(self, loss: BaseLoss):
        super().__init__(scalers=None, ignore_nans=loss.ignore_nans)
        self.loss = loss

    def to(self, device) -> "_Wrapper":
        self.loss.to(device)
        return self


@register_loss("LossVariableMapper")
class LossVariableMapper(_Wrapper):
    """Filter the variable axis before the wrapped loss.

    ``predicted_variables`` selects model-output variables and
    ``target_variables`` (default: the same names) the target columns they
    are scored against; the layouts name each tensor's index space.  With
    ``squash=False`` the per-variable losses are placed back at the full
    model-output width, zeros elsewhere."""

    def __init__(
        self,
        loss: BaseLoss,
        data_indices,
        predicted_variables: Optional[List[str]] = None,
        target_variables: Optional[List[str]] = None,
        pred_layout: str = "model_output",
        target_layout: str = "data_output",
    ):
        super().__init__(loss)
        if (predicted_variables is not None and target_variables is not None
                and len(predicted_variables) != len(target_variables)):
            raise ValueError("predicted and target variables must have the same length")
        if predicted_variables is None:
            predicted_variables = list(data_indices.model.output.ordered_names)
        if target_variables is None:
            target_variables = list(predicted_variables)
        self.predicted_variables = list(predicted_variables)
        self.target_variables = list(target_variables)
        self.pred_layout = pred_layout
        self.target_layout = target_layout
        self.data_indices = data_indices
        self.pred_indices = self._resolve(self.predicted_variables, pred_layout)
        self.target_indices = self._resolve(self.target_variables, target_layout)
        self._pred_idx = torch.as_tensor(self.pred_indices, dtype=torch.long)
        self._target_idx = torch.as_tensor(self.target_indices, dtype=torch.long)
        self._filter_variable_scalers()

    def _resolve(self, names: Sequence[str], layout: str) -> List[int]:
        table = _layout_table(self.data_indices, layout)
        missing = [n for n in names if n not in table]
        if missing:
            raise ValueError(f"Cannot resolve variables {missing} in layout '{layout}'. "
                             f"Available: {sorted(table)}")
        return [table[n] for n in names]

    def _filter_variable_scalers(self) -> None:
        """Every variable-axis scaler of the wrapped loss, cut to the
        selected prediction variables, taken from the index space its size
        names; size-1 scalers and scalers already of the subset's size pass
        through."""
        n_sel = len(self.pred_indices)
        n_model_out = len(self.data_indices.model.output.ordered_names)
        n_data_out = len(self.data_indices.data.output.ordered_names)
        layout_sizes = {n_model_out, n_data_out, len(self.data_indices.data_full_name_to_position)}
        filtered = {}
        for name, (dims, arr) in self.loss.scalers.scalers.items():
            if "variable" in dims:
                axis = dims.index("variable")
                size = arr.shape[axis]
                if size in (n_sel, 1):
                    pass
                elif size in layout_sizes:
                    if size == n_model_out:
                        layout = "model_output"
                    elif size == n_data_out:
                        layout = "data_output"
                    else:
                        layout = "data_full"
                    idx = self._resolve(self.predicted_variables, layout)
                    arr = arr.index_select(axis, torch.as_tensor(idx, dtype=torch.long,
                                                                 device=arr.device))
                else:
                    raise ValueError(
                        f"Cannot map VARIABLE-axis scaler '{name}' (size {size}) to a known "
                        f"index space; known sizes: {sorted(layout_sizes)}")
            filtered[name] = (dims, arr)
        self.loss.scalers = ScaleTensor._of(filtered)

    def __call__(self, pred, target, squash: bool = True, **kwargs):
        pred_idx = self._pred_idx.to(pred.device)
        pred_f = pred.index_select(-1, pred_idx)
        target_f = target.index_select(-1, self._target_idx.to(target.device))
        if squash:
            return self.loss(pred_f, target_f, squash=True, **kwargs)
        per_var = self.loss(pred_f, target_f, squash=False, **kwargs)
        out = torch.zeros(pred.shape[-1], dtype=per_var.dtype, device=per_var.device)
        return out.index_copy(0, pred_idx, per_var)


@register_loss("TimeAggregateLossWrapper")
class TimeAggregateLossWrapper(_Wrapper):
    """The wrapped loss on time aggregates of the window:
    ``time_aggregation_types`` from ``diff`` (each step's difference from
    the one before, weighted by the wrapped loss's time scaler if it has
    one), ``mean``, ``min``, ``max``; averaged over the types."""

    _AGG = {"mean": lambda x: x.mean(dim=1, keepdim=True),
            "min": lambda x: x.amin(dim=1, keepdim=True),
            "max": lambda x: x.amax(dim=1, keepdim=True)}

    def __init__(self, loss: BaseLoss, time_aggregation_types: Sequence[str]):
        super().__init__(loss)
        for op in time_aggregation_types:
            if op != "diff" and op not in self._AGG:
                raise ValueError(f"Unknown aggregation type '{op}'. Supported: 'diff', "
                                 f"{sorted(self._AGG)}.")
        self.time_aggregation_types = list(time_aggregation_types)
        # the time scalers stay out of the inner calls: aggregation changes
        # the time length, and "diff" applies the first one's weights itself
        self._time_scaler_names = [n for n, (dims, _) in loss.scalers.scalers.items()
                                   if "time" in dims]

    def _time_weights(self) -> Optional[torch.Tensor]:
        if not self._time_scaler_names:
            return None
        return self.loss.scalers.scalers[self._time_scaler_names[0]][1].reshape(-1)

    def __call__(self, pred, target, squash: bool = True, **kwargs):
        if pred.shape[1] <= 1:
            raise ValueError("TimeAggregateLossWrapper requires a time dimension > 1")
        without = list(kwargs.pop("without_scalers", None) or [])
        without += [n for n in self._time_scaler_names if n not in without]
        total = 0.0
        for op in self.time_aggregation_types:
            if op == "diff":
                total = total + self._diff_loss(pred, target, squash, without, kwargs)
            else:
                agg = self._AGG[op]
                total = total + self.loss(agg(pred), agg(target), squash=squash,
                                          without_scalers=without, **kwargs)
        return total / max(len(self.time_aggregation_types), 1)

    def _diff_loss(self, pred, target, squash, without, kwargs):
        dp = pred[:, 1:] - pred[:, :-1]
        dt = target[:, 1:] - target[:, :-1]
        weights = self._time_weights()
        total = 0.0
        for step in range(dp.shape[1]):
            step_loss = self.loss(dp[:, step : step + 1], dt[:, step : step + 1], squash=squash,
                                  without_scalers=without, **kwargs)
            if weights is not None and step < weights.shape[0]:
                step_loss = step_loss * weights[step].to(step_loss.device)
            total = total + step_loss
        return total
