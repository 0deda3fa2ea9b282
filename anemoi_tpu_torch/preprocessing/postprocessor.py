"""Output postprocessors.

Port of ``anemoi_tpu.preprocessing.postprocessor``: ``transform`` is the
identity (inputs are untouched) and ``inverse_transform`` corrects the
model-output variables of ``[..., V_out]``:

- ``Postprocessor``: ``relu``, ``hardtanh`` or ``hardtanh_0_1``;
- ``NormalizedReluPostprocessor``: ``max(x, c)`` with the threshold ``c``
  given in physical units and mapped through the variable's normalisation;
- ``ConditionalZeroPostprocessor``: where the masking variable (``remap``)
  is 0, the selected outputs take the given values;
- ``ConditionalNaNPostprocessor``: where it is NaN, they become NaN.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from anemoi_tpu_torch.data_indices.collection import IndexCollection


class Postprocessor:
    """methods: ``{"relu": [vars]}``, ``{"hardtanh": [...]}``,
    ``{"hardtanh_0_1": [...]}``."""

    _FUNCS = ("relu", "hardtanh", "hardtanh_0_1")

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
        model_out = data_indices.model.output.name_to_index
        self.num_model_output_vars = len(model_out)

        per_var: Dict[str, object] = {}
        for method, variables in (methods or {}).items():
            for name in variables:
                per_var[name] = method
        self.method_of = {name: per_var.get(name, default) for name in model_out}
        for name, m in self.method_of.items():
            self._check_method(m, name)

        lo = np.full(self.num_model_output_vars, -np.inf, dtype=np.float32)
        hi = np.full(self.num_model_output_vars, np.inf, dtype=np.float32)
        for name, j in model_out.items():
            if self.method_of[name] != "none":
                lo[j], hi[j] = self._bounds(self.method_of[name], name)
        self._lo = torch.as_tensor(lo, device=device)
        self._hi = torch.as_tensor(hi, device=device)

    def _check_method(self, method, name):
        if method != "none" and method not in self._FUNCS:
            raise ValueError(f"Unknown postprocessing method '{method}'")

    def _bounds(self, method, name):
        return {"relu": (0.0, np.inf), "hardtanh": (-1.0, 1.0), "hardtanh_0_1": (0.0, 1.0)}[method]

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        return x

    def inverse_transform(self, x: torch.Tensor, aux=None) -> torch.Tensor:
        if x.shape[-1] != self.num_model_output_vars:
            return x
        return torch.clamp(x, self._lo.to(x.dtype), self._hi.to(x.dtype))


class NormalizedReluPostprocessor(Postprocessor):
    """``max(x, threshold)``, the thresholds numeric-keyed in physical units
    (``{-2.0: [sst]}``) and mapped through ``normalizer`` (``none``,
    ``mean-std``, ``min-max``, ``max``, ``std``)."""

    def __init__(self, data_indices, statistics=None, default="none", methods=None,
                 normalizer: str = "none", device: torch.device | str = "cpu"):
        if normalizer not in {"none", "mean-std", "min-max", "max", "std"}:
            raise ValueError(f"Unknown normalizer '{normalizer}'")
        self.normalizer = normalizer
        super().__init__(data_indices, statistics, default, methods, device=device)

    def _check_method(self, method, name):
        if method != "none":
            float(method)  # numeric-keyed

    def _bounds(self, method, name):
        thr = float(method)
        i = self.data_indices.name_to_index[name]

        def stat(key):
            return float(np.asarray(self.statistics[key])[i])

        if self.normalizer == "mean-std":
            thr = (thr - stat("mean")) / stat("stdev")
        elif self.normalizer == "min-max":
            thr = (thr - stat("minimum")) / max(stat("maximum") - stat("minimum"), 1e-12)
        elif self.normalizer == "max":
            thr = thr / max(stat("maximum"), 1e-12)
        elif self.normalizer == "std":
            thr = thr / max(stat("stdev"), 1e-12)
        return thr, np.inf


class ConditionalPostprocessor(Postprocessor):
    """Set the selected outputs to per-variable values where the masking
    variable ``remap`` meets :meth:`condition`; methods numeric-keyed,
    ``{0.0: [cp]}``."""

    def __init__(self, data_indices, statistics=None, default="none", methods=None,
                 remap: Optional[str] = None, device: torch.device | str = "cpu"):
        if remap is None:
            raise ValueError("a conditional postprocessor needs 'remap' (the masking variable)")
        self.masking_variable = remap
        super().__init__(data_indices, statistics, default, methods, device=device)
        model_out = data_indices.model.output.name_to_index
        self.masking_index = model_out.get(remap)
        fill = np.zeros(self.num_model_output_vars, dtype=np.float32)
        active = np.zeros(self.num_model_output_vars, dtype=bool)
        for name, j in model_out.items():
            if self.method_of[name] != "none":
                active[j] = True
                fill[j] = float(self.method_of[name])
        self._fill = torch.as_tensor(fill, device=device)
        self._active = torch.as_tensor(active, device=device)

    def _check_method(self, method, name):
        if method != "none":
            float(method)

    def _bounds(self, method, name):
        return -np.inf, np.inf  # unused: a conditional fill, not a clip

    def condition(self, masking: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def inverse_transform(self, x: torch.Tensor, aux=None) -> torch.Tensor:
        if x.shape[-1] != self.num_model_output_vars or self.masking_index is None:
            return x
        cond = self.condition(x[..., self.masking_index])[..., None]
        return torch.where(cond & self._active, self._fill.to(x.dtype), x)


class ConditionalZeroPostprocessor(ConditionalPostprocessor):
    """Where the masking variable is 0, the outputs take the given values."""

    def condition(self, masking: torch.Tensor) -> torch.Tensor:
        return masking == 0.0


class ConditionalNaNPostprocessor(ConditionalPostprocessor):
    """Where the masking variable is NaN, the selected outputs become NaN;
    they may be listed under any numeric key or under ``nan``."""

    def __init__(self, data_indices, statistics=None, default="none", methods=None,
                 remap: Optional[str] = None, device: torch.device | str = "cpu"):
        methods = {0.0 if k == "nan" else k: v for k, v in (methods or {}).items()}
        super().__init__(data_indices, statistics, default, methods, remap=remap, device=device)
        self._fill = torch.where(self._active, torch.full_like(self._fill, float("nan")),
                                 self._fill)

    def condition(self, masking: torch.Tensor) -> torch.Tensor:
        return torch.isnan(masking)
