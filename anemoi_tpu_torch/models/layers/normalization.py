"""Normalization layers.

Port of ``anemoi_tpu.models.layers.normalization``: LayerNorm with float32
statistics whose output is cast back to the input type (anemoi-core's
AutocastLayerNorm), the query/key norm over the per-head dim (a scale-only
LayerNorm, or an RMS norm with ``kind="rmsnorm"``), and the
``ConditionalLayerNorm`` of the ensemble's noise conditioning.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim, statistics in float32, eps 1e-5."""

    def __init__(self, normalized_shape: int, eps: float = 1e-5, bias: bool = True) -> None:
        super().__init__(normalized_shape, eps=eps, bias=bias)

    def forward(self, x: torch.Tensor, cond: torch.Tensor | None = None) -> torch.Tensor:
        # a plain LayerNorm ignores the conditioning, as the JAX one does
        weight = None if self.weight is None else self.weight.float()
        bias = None if self.bias is None else self.bias.float()
        return F.layer_norm(x.float(), self.normalized_shape, weight, bias, self.eps).to(x.dtype)


class RMSNorm(nn.Module):
    """RMS norm with a scale, float32 statistics, eps 1e-6 (flax's
    ``nn.RMSNorm``), cast back to the input type."""

    def __init__(self, normalized_shape: int, eps: float = 1e-6) -> None:
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(normalized_shape))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.rms_norm(x.float(), self.weight.shape, self.weight.float(), self.eps).to(x.dtype)


def QKNorm(head_dim: int, kind: str = "layernorm") -> nn.Module:
    """Query/key normalisation over the per-head dim ``d``, applied to
    ``[..., H, d]``: ``layernorm`` is a scale-only LayerNorm, anemoi-core's
    default QueryNorm/KeyNorm kernel; ``rmsnorm`` the RMS norm."""
    if kind == "rmsnorm":
        return RMSNorm(head_dim)
    if kind != "layernorm":
        raise ValueError(f"unknown qk_norm_type '{kind}': expected layernorm|rmsnorm")
    return LayerNorm(head_dim, bias=False)


class ConditionalLayerNorm(nn.Module):
    """``LN(x) * (scale(cond) + 1) + bias(cond)``: a LayerNorm without affine
    parameters in float32, its scale and offset predicted from the
    conditioning ``cond [..., cond_dim]`` by two Linear layers that start at
    zero (so the norm starts as a plain LayerNorm); cast back to the input
    type.  The Linears run in ``cond``'s type, as the JAX Dense layers run in
    the compute type of their parameters."""

    def __init__(self, normalized_shape: int, cond_dim: int, eps: float = 1e-5) -> None:
        super().__init__()
        self.normalized_shape = (normalized_shape,)
        self.eps = eps
        self.scale = nn.Linear(cond_dim, normalized_shape)
        self.bias = nn.Linear(cond_dim, normalized_shape)
        self.zero_()

    @torch.no_grad()
    def zero_(self) -> None:
        for lin in (self.scale, self.bias):
            lin.weight.zero_()
            lin.bias.zero_()

    def forward(self, x: torch.Tensor, cond: torch.Tensor | None) -> torch.Tensor:
        if cond is None:
            raise ValueError("a conditional layer norm needs the conditioning (cond)")
        normed = F.layer_norm(x.float(), self.normalized_shape, None, None, self.eps)
        return (normed * (self.scale(cond) + 1.0) + self.bias(cond)).to(x.dtype)


def norm(channels: int, cond_dim: int | None) -> nn.Module:
    """A block's norm: conditional when the block has a conditioning width."""
    return LayerNorm(channels) if cond_dim is None else ConditionalLayerNorm(channels, cond_dim)
