"""Normalization layers.

Port of ``anemoi_tpu.models.layers.normalization``: LayerNorm with float32
statistics whose output is cast back to the input type (anemoi-core's
AutocastLayerNorm), and the query/key norm over the per-head dim.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim, statistics in float32, eps 1e-5."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5, bias: bool = True) -> None:
        super().__init__(normalized_shape, eps=eps, bias=bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        weight = None if self.weight is None else self.weight.float()
        bias = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, weight, bias, self.eps).to(x.dtype)


class QKNorm(LayerNorm):
    """Query/key normalisation over the per-head dim ``d``: a scale-only
    LayerNorm, anemoi-core's default QueryNorm/KeyNorm kernel.  Applied to
    ``[..., H, d]``."""

    def __init__(self, head_dim: int) -> None:
        super().__init__(head_dim, bias=False)
