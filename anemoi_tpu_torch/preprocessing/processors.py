"""Processor chain: ordered pre/post-processing.

Port of ``anemoi_tpu.preprocessing.processors``: ``Processors`` runs each
processor's transform in order and the inverse transforms in reverse
order; ``StepwiseProcessors`` holds one chain per forecast lead time.  An
imputer's NaN bookkeeping is explicit data flow: ``aux =
chain.compute_aux(raw_batch)``, ``chain.inverse_transform(y, aux=aux)``
puts the NaNs back and ``chain.loss_mask(aux)`` is the loss weight that
zeroes them.  The variable-expanding ``Remapper`` is not in the name table:
``models/interface.py`` builds it first and puts it at the head of the chain.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.preprocessing.imputer import (
    BaseImputer,
    ConstantImputer,
    CopyImputer,
    DynamicConstantImputer,
    DynamicCopyImputer,
    DynamicInputImputer,
    InputImputer,
)
from anemoi_tpu_torch.preprocessing.normalizer import InputNormalizer
from anemoi_tpu_torch.preprocessing.postprocessor import (
    ConditionalNaNPostprocessor,
    ConditionalZeroPostprocessor,
    NormalizedReluPostprocessor,
    Postprocessor,
)
from anemoi_tpu_torch.preprocessing.remapper import CosSinRemapper


def _cos_sin_remapper(data_indices, statistics=None, device="cpu", **cfg):
    return CosSinRemapper(data_indices, cfg.get("config"))


PROCESSORS = {
    "InputNormalizer": InputNormalizer,
    "InputImputer": InputImputer,
    "ConstantImputer": ConstantImputer,
    "CopyImputer": CopyImputer,
    "DynamicInputImputer": DynamicInputImputer,
    "DynamicConstantImputer": DynamicConstantImputer,
    "DynamicCopyImputer": DynamicCopyImputer,
    "Postprocessor": Postprocessor,
    "NormalizedReluPostprocessor": NormalizedReluPostprocessor,
    "ConditionalZeroPostprocessor": ConditionalZeroPostprocessor,
    "ConditionalNaNPostprocessor": ConditionalNaNPostprocessor,
    "CosSinRemapper": _cos_sin_remapper,
}
# keys of a processor's config that are not per-variable methods
_RESERVED = {"name", "default", "value", "normalizer", "remap", "methods", "config"}


class Processors:
    def __init__(self, processors: List) -> None:
        self.processors = list(processors)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        for p in self.processors:
            x = p.transform(x)
        return x

    def inverse_transform(self, x: torch.Tensor, aux=None) -> torch.Tensor:
        for p in reversed(self.processors):
            x = p.inverse_transform(x, aux=aux)
        return x

    def _imputer(self) -> Optional[BaseImputer]:
        return next((p for p in self.processors if isinstance(p, BaseImputer)), None)

    def compute_aux(self, x_raw: torch.Tensor) -> Optional[dict]:
        """The first imputer's NaN bookkeeping of a raw batch, or None."""
        imputer = self._imputer()
        return None if imputer is None else imputer.compute_aux(x_raw)

    def loss_mask(self, aux) -> Optional[torch.Tensor]:
        imputer = self._imputer()
        return None if aux is None or imputer is None else imputer.loss_mask(aux)

    @property
    def has_imputer(self) -> bool:
        return self._imputer() is not None


class StepwiseProcessors:
    """One chain per forecast lead time, possibly sparse; lead times are
    string keys (``"6h"``, ``"12h"``, ...) and a missing one gives None."""

    def __init__(self, lead_times: List[str]) -> None:
        self._lead_times = [str(t) for t in lead_times]
        self._processors: Dict[str, Processors] = {}

    def __len__(self) -> int:
        return len(self._lead_times)

    def __iter__(self):
        for lead_time in self._lead_times:
            yield self._processors.get(lead_time)

    def __getitem__(self, index) -> Optional[Processors]:
        key = self._lead_times[index] if isinstance(index, int) else str(index)
        return self._processors.get(key)

    @property
    def lead_times(self) -> List[str]:
        return list(self._lead_times)

    def set(self, lead_time, processors: Processors) -> None:
        key = str(lead_time)
        if key not in self._lead_times:
            self._lead_times.append(key)
        self._processors[key] = processors

    def transform(self, x: torch.Tensor, step: int) -> torch.Tensor:
        chain = self[step]
        return x if chain is None else chain.transform(x)

    def inverse_transform(self, x: torch.Tensor, step: int, aux=None) -> torch.Tensor:
        chain = self[step]
        return x if chain is None else chain.inverse_transform(x, aux=aux)


def build_processors(
    configs: Optional[List[dict]],
    data_indices: IndexCollection,
    statistics: Dict[str, np.ndarray],
    device: torch.device | str = "cpu",
) -> Processors:
    """The ordered chain from entries like ``[{"name": "InputImputer",
    "default": "mean"}, {"name": "InputNormalizer", "default":
    "mean-std"}]``.  Method keys given at the top level of an entry, as the
    reference writes them (``{"default": "none", "mean": [y], 3.14: [q]}``),
    are folded into its ``methods``."""
    processors = []
    for cfg in configs or []:
        cfg = dict(cfg)
        name = cfg.pop("name")
        if name not in PROCESSORS:
            raise NotImplementedError(f"preprocessor '{name}' is not ported to anemoi_tpu_torch")
        extra = {k: cfg.pop(k) for k in list(cfg)
                 if k not in _RESERVED and isinstance(cfg[k], (list, tuple))}
        if extra:
            cfg["methods"] = {**(cfg.get("methods") or {}), **extra}
        processors.append(PROCESSORS[name](data_indices, statistics, device=device, **cfg))
    return Processors(processors)


def build_stepwise_processors(
    configs: Dict[str, Optional[List[dict]]],
    data_indices: IndexCollection,
    statistics: Dict[str, np.ndarray],
    device: torch.device | str = "cpu",
) -> StepwiseProcessors:
    """``{lead_time: [processor configs] | None}`` -> ``StepwiseProcessors``."""
    stepwise = StepwiseProcessors(list(configs))
    for lead_time, cfgs in configs.items():
        if cfgs is not None:
            stepwise.set(lead_time, build_processors(cfgs, data_indices, statistics, device))
    return stepwise
