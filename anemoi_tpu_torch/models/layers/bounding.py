"""Output boundings: physical ranges enforced on the model's outputs.

Port of ``anemoi_tpu.models.layers.bounding``: ``relu``, ``leaky_relu``,
``hardtanh``, ``leaky_hardtanh``, ``fraction`` and ``leaky_fraction``,
applied in config order after the residual.  Each is evaluated on the whole
variable dim and selected back by a boolean mask of its variables (the JAX
package's scatter-free form); the fractions scale by another output
variable (``total_var``).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch
from torch import nn


def _leaky_hardtanh(x, min_val, max_val, slope=0.01):
    below = torch.clamp(x - min_val, max=0.0) * slope
    above = torch.clamp(x - max_val, min=0.0) * slope
    return torch.clamp(x, min_val, max_val) + below + above


class Bounding(nn.Module):
    """One bounding: the transform ``fn`` on the variables ``indices`` of the
    last dim (of ``num_vars``), the others unchanged.  ``total_indices``: the
    one variable the fractions scale by."""

    def __init__(self, indices: Sequence[int], fn: Callable, num_vars: int,
                 total_indices: Optional[Sequence[int]] = None) -> None:
        super().__init__()
        mask = torch.zeros(num_vars, dtype=torch.bool)
        mask[torch.as_tensor(list(indices), dtype=torch.long)] = True
        self.register_buffer("var_mask", mask, persistent=False)
        self.total_indices = None if total_indices is None else list(total_indices)
        self.fn = fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.total_indices is not None:
            transformed = self.fn(x, x[..., self.total_indices])
        else:
            transformed = self.fn(x)
        return torch.where(self.var_mask, transformed, x)


def _resolve(variables: Sequence[str], name_to_index: Dict[str, int]) -> List[int]:
    missing = [v for v in variables if v not in name_to_index]
    if missing:
        raise KeyError(f"Bounding variables {missing} not in output space {sorted(name_to_index)}")
    return [name_to_index[v] for v in variables]


def relu_bounding(variables, name_to_index, **_) -> Bounding:
    return Bounding(_resolve(variables, name_to_index), lambda x: torch.clamp(x, min=0.0),
                    len(name_to_index))


def leaky_relu_bounding(variables, name_to_index, negative_slope: float = 0.01, **_) -> Bounding:
    return Bounding(_resolve(variables, name_to_index),
                    lambda x: torch.where(x >= 0, x, negative_slope * x), len(name_to_index))


def hardtanh_bounding(variables, name_to_index, min_val: float, max_val: float, **_) -> Bounding:
    return Bounding(_resolve(variables, name_to_index),
                    lambda x: torch.clamp(x, min_val, max_val), len(name_to_index))


def leaky_hardtanh_bounding(variables, name_to_index, min_val: float, max_val: float,
                            slope: float = 0.01, **_) -> Bounding:
    return Bounding(_resolve(variables, name_to_index),
                    lambda x: _leaky_hardtanh(x, min_val, max_val, slope), len(name_to_index))


def fraction_bounding(variables, name_to_index, min_val: float, max_val: float, total_var: str,
                      **_) -> Bounding:
    return Bounding(_resolve(variables, name_to_index),
                    lambda x, total: torch.clamp(x, min_val, max_val) * total,
                    len(name_to_index), total_indices=_resolve([total_var], name_to_index))


def leaky_fraction_bounding(variables, name_to_index, min_val: float, max_val: float,
                            total_var: str, slope: float = 0.01, **_) -> Bounding:
    return Bounding(_resolve(variables, name_to_index),
                    lambda x, total: _leaky_hardtanh(x, min_val, max_val, slope) * total,
                    len(name_to_index), total_indices=_resolve([total_var], name_to_index))


BOUNDINGS = {"relu": relu_bounding, "leaky_relu": leaky_relu_bounding,
             "hardtanh": hardtanh_bounding, "leaky_hardtanh": leaky_hardtanh_bounding,
             "fraction": fraction_bounding, "leaky_fraction": leaky_fraction_bounding}


def build_boundings(configs: Optional[List[dict]], name_to_index: Dict[str, int]) -> nn.ModuleList:
    """The ordered boundings of ``model.bounding`` (each ``{name, variables,
    ...}``) over the output variables ``name_to_index``."""
    out = nn.ModuleList()
    for cfg in configs or []:
        cfg = dict(cfg)
        name = cfg.pop("name")
        if name not in BOUNDINGS:
            raise ValueError(f"unknown bounding '{name}' (known: {sorted(BOUNDINGS)})")
        out.append(BOUNDINGS[name](name_to_index=name_to_index, **cfg))
    return out
