"""NaN imputation.

Port of ``anemoi_tpu.preprocessing.imputer``: replace the NaNs of selected
variables before the model and put them back after it.

- ``InputImputer``: fill from per-variable statistics (``mean``, ``stdev``,
  ``minimum``, ``maximum``) or a ``constant`` (``value``);
- ``ConstantImputer``: numeric-keyed methods, ``{1.0: [x, y]}``;
- ``CopyImputer``: the value of another variable, ``{source: [x, y]}``;
- the ``Dynamic*`` variants, the same classes (these imputers read the NaN
  mask from each call's data already).

The NaN mask travels explicitly, as in the JAX package:
``aux = imputer.compute_aux(raw_batch)``, then
``inverse_transform(y, aux=aux)`` puts NaNs back at the input's NaN
locations and ``loss_mask(aux)`` zeroes the loss there.  The mask is taken
from the first time step and the first ensemble member.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from anemoi_tpu_torch.data_indices.collection import IndexCollection


class BaseImputer:
    """The index bookkeeping every imputer shares."""

    def __init__(
        self,
        data_indices: IndexCollection,
        statistics: Optional[Dict[str, np.ndarray]] = None,
        default="none",
        methods: Optional[Dict] = None,
        device: torch.device | str = "cpu",
    ) -> None:
        self.data_indices = data_indices
        self.statistics = statistics or {}
        name_to_index = data_indices.name_to_index
        self.num_data_vars = len(name_to_index)
        model_in = data_indices.model.input.name_to_index
        model_out = data_indices.model.output.name_to_index
        self.num_model_input_vars = len(model_in)
        self.num_model_output_vars = len(model_out)

        # per-variable method: variables listed under a method override the default
        per_var: Dict[str, object] = {}
        for method, variables in (methods or {}).items():
            for name in variables:
                per_var[name] = method
        self.method_of = {name: per_var.get(name, default) for name in name_to_index}

        def tables(space: Dict[str, int], width: int, src_of):
            """(fill, active, copy source, is copy) over one variable space."""
            fill = np.zeros(width, dtype=np.float32)
            active = np.zeros(width, dtype=bool)
            copy_src = np.zeros(width, dtype=np.int64)
            is_copy = np.zeros(width, dtype=bool)
            for name, j in space.items():
                method = self.method_of[name]
                if method == "none":
                    continue
                active[j] = True
                if self._is_copy_method(method):
                    is_copy[j] = True
                    copy_src[j] = src_of(str(method))
                else:
                    fill[j] = self._fill_value(method, name, name_to_index[name])
            return tuple(torch.as_tensor(a, device=device) for a in (fill, active, copy_src,
                                                                      is_copy))

        def model_input_source(src: str) -> int:
            if src not in model_in:
                raise ValueError(f"CopyImputer source '{src}' is not a model input")
            return model_in[src]

        self._data = tables(name_to_index, self.num_data_vars, name_to_index.__getitem__)
        self._model_in = tables(model_in, self.num_model_input_vars, model_input_source)

        # inverse and loss mask: model-output variable -> model-input variable,
        # for the imputed variables in both
        out_from_in = np.full(self.num_model_output_vars, -1, dtype=np.int64)
        for name, j_out in model_out.items():
            if name in model_in and self.method_of.get(name, "none") != "none":
                out_from_in[j_out] = model_in[name]
        self._out_src = torch.as_tensor(np.clip(out_from_in, 0, None), device=device)
        self._out_imputed = torch.as_tensor(out_from_in >= 0, device=device)
        self._data_input = torch.as_tensor(
            np.asarray(data_indices.data.input.full, dtype=np.int64), device=device)

    # -- the flavours' hooks -------------------------------------------
    def _is_copy_method(self, method) -> bool:
        return False

    def _fill_value(self, method, name: str, data_index: int) -> float:
        raise NotImplementedError

    # -- API ------------------------------------------------------------
    def transform(self, x: torch.Tensor) -> torch.Tensor:
        """Fill the NaNs of the active variables of a data-space
        ``[..., V_data]`` or model-input-space ``[..., V_model_in]`` tensor
        (chosen by its trailing dim); any other width passes through."""
        v = x.shape[-1]
        if v == self.num_data_vars:
            fill, active, copy_src, is_copy = self._data
        elif v == self.num_model_input_vars:
            fill, active, copy_src, is_copy = self._model_in
        else:
            return x
        replacement = torch.where(is_copy, x[..., copy_src], fill.to(x.dtype))
        return torch.where(torch.isnan(x) & active, replacement, x)

    def compute_aux(self, x_raw: torch.Tensor) -> Dict[str, torch.Tensor]:
        """NaN bookkeeping of the RAW batch ``[B, T, E, G, V]``:
        ``nan_mask_in`` ``[B, G, V_in]``, the NaNs of the first time step and
        member in model-input space; ``loss_mask`` ``[B, G, V_out]``, 0 where
        an imputed input that is also an output was NaN."""
        first = x_raw[:, 0]
        while first.dim() > 3:
            first = first[:, 0]
        nan_mask = torch.isnan(first)
        nan_in = nan_mask[..., self._data_input] if nan_mask.shape[-1] == self.num_data_vars \
            else nan_mask
        masked_out = nan_in[..., self._out_src] & self._out_imputed
        return {"nan_mask_in": nan_in, "loss_mask": 1.0 - masked_out.to(torch.float32)}

    def loss_mask(self, aux) -> torch.Tensor:
        return aux["loss_mask"]

    def inverse_transform(self, x: torch.Tensor, aux: Optional[Dict[str, torch.Tensor]] = None
                          ) -> torch.Tensor:
        """NaNs back at the input's NaN locations of the imputed output
        variables of ``[B, T, E, G, V_out]``; without ``aux`` the identity."""
        if aux is None or x.shape[-1] != self.num_model_output_vars:
            return x
        mask = aux["nan_mask_in"][..., self._out_src] & self._out_imputed  # [B, G, V_out]
        mask = mask.reshape(mask.shape[0], *([1] * (x.dim() - 3)), *mask.shape[1:])
        return torch.where(mask, torch.full((), float("nan"), dtype=x.dtype, device=x.device), x)


class InputImputer(BaseImputer):
    """Statistics-based fills: ``mean``, ``stdev``, ``minimum``, ``maximum``,
    ``constant`` (with ``value``) or ``none``."""

    def __init__(self, data_indices, statistics=None, default="none", methods=None,
                 value: float = 0.0, device: torch.device | str = "cpu"):
        self._constant_value = float(value)
        super().__init__(data_indices, statistics, default, methods, device=device)

    def _fill_value(self, method, name, data_index):
        if method == "constant":
            return self._constant_value
        if method in ("mean", "stdev", "minimum", "maximum"):
            return float(np.asarray(self.statistics[method])[data_index])
        raise ValueError(f"Unknown imputation method '{method}'")


class ConstantImputer(BaseImputer):
    """Numeric-keyed methods, ``{0: [x], 3.14: [q]}``: the key is the fill."""

    def _fill_value(self, method, name, data_index):
        return float(method)


class CopyImputer(BaseImputer):
    """The value of another variable at the NaN location:
    ``{source_variable: [missing_1, missing_2]}``."""

    def _is_copy_method(self, method) -> bool:
        return method != "none"


class DynamicInputImputer(InputImputer):
    pass


class DynamicConstantImputer(ConstantImputer):
    pass


class DynamicCopyImputer(CopyImputer):
    pass
