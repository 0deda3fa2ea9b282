"""Feed-forward layers.

Port of ``anemoi_tpu.models.layers.mlp`` as the GraphTransformer uses it: one
hidden layer, either a Linear with the exact (erf) GELU -- torch.nn.GELU's
default and the JAX package's ``gelu`` (``nn.gelu(approximate=False)``) --
or, with ``implementation`` glu / swiglu / geglu / reglu, the gated layer
``act(gate_proj(x)) * value_proj(x)`` with act sigmoid / SiLU / tanh-GELU
(flax's ``nn.gelu`` default) / ReLU, the JAX package's ``GATING``.  Linear
layers are laid out as anemoi-core's ``MLP.mlp`` Sequential (``mlp.0`` the
hidden layer, ``mlp.2`` the output Linear), so reference state-dict names
load as they are; a gated hidden layer keeps its ``gate_proj`` and
``value_proj`` under ``mlp.0``.  Extra hidden layers and other activations
are not ported.

The hidden activation is one ``torch.library`` op, :func:`mlp_hidden` (the
GELU, or the gated product), so that a checkpoint policy sees it:
``save_attention_mlp`` (``models/layers/remat.py``) keeps its ``[N, ratio *
C]`` output, as the JAX package keeps the activation it tags
``mlp_hidden``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from anemoi_tpu_torch.models.layers.normalization import LayerNorm

# the gated variants' activation of the gate
GATING = {"glu": "sigmoid", "swiglu": "silu", "geglu": "gelu_tanh", "reglu": "relu"}


def compute_mlp_hidden_dim(dim: int, ratio: float) -> int:
    return int(dim * ratio)


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu":
        return F.gelu(x)
    if activation == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation == "silu":
        return F.silu(x)
    if activation == "relu":
        return F.relu(x)
    raise ValueError(f"unknown activation '{activation}'")


def _act_backward(grad: torch.Tensor, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu":
        return torch.ops.aten.gelu_backward(grad, x)
    if activation == "gelu_tanh":
        return torch.ops.aten.gelu_backward(grad, x, approximate="tanh")
    if activation == "sigmoid":
        s = torch.sigmoid(x)
        return grad * s * (1 - s)
    if activation == "silu":
        return torch.ops.aten.silu_backward(grad, x)
    return grad * (x > 0).to(grad.dtype)  # relu


@torch.library.custom_op("anemoi_tpu_torch::mlp_hidden", mutates_args=())
def mlp_hidden(x: torch.Tensor, value: Optional[torch.Tensor] = None,
               activation: str = "gelu") -> torch.Tensor:
    """The hidden layer's activation, as an op a checkpoint policy can name:
    ``act(x)``, or the gated product ``act(x) * value``."""
    out = _act(x, activation)
    return out if value is None else out * value


@mlp_hidden.register_fake
def _(x, value=None, activation="gelu"):
    return torch.empty_like(x)


def _mlp_hidden_setup_context(ctx, inputs, output):
    x, value, activation = inputs
    ctx.activation = activation
    ctx.gated = value is not None
    ctx.save_for_backward(x, value)


def _mlp_hidden_backward(ctx, grad):
    x, value = ctx.saved_tensors
    if not ctx.gated:
        return _act_backward(grad, x, ctx.activation), None, None
    return _act_backward(grad * value, x, ctx.activation), grad * _act(x, ctx.activation), None


mlp_hidden.register_autograd(_mlp_hidden_backward, setup_context=_mlp_hidden_setup_context)


class HiddenGELU(nn.Module):
    """Exact GELU through :func:`mlp_hidden`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_hidden(x)


class GatedFeedForward(nn.Module):
    """``act(gate_proj(x)) * value_proj(x)``, the product through
    :func:`mlp_hidden`."""

    def __init__(self, in_features: int, out_features: int, implementation: str) -> None:
        super().__init__()
        if implementation not in GATING:
            raise ValueError(f"Unknown mlp implementation '{implementation}'")
        self.activation = GATING[implementation]
        self.gate_proj = nn.Linear(in_features, out_features)
        self.value_proj = nn.Linear(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_hidden(self.gate_proj(x), self.value_proj(x), self.activation)


def feed_forward(in_features: int, out_features: int, implementation: str = "mlp"):
    """The hidden layer as two Sequential entries: Linear then exact GELU, or
    the gated layer then nothing (keeping the output Linear at ``mlp.2``)."""
    if implementation == "mlp":
        return nn.Linear(in_features, out_features), HiddenGELU()
    return GatedFeedForward(in_features, out_features, implementation), nn.Identity()


class MLP(nn.Module):
    """in -> hidden layer (``implementation``) -> out, with an optional
    trailing LayerNorm."""

    def __init__(self, in_features: int, hidden_dim: int, out_features: int,
                 layer_norm: bool = True, implementation: str = "mlp") -> None:
        super().__init__()
        self.mlp = nn.Sequential(
            *feed_forward(in_features, hidden_dim, implementation),
            nn.Linear(hidden_dim, out_features),
        )
        self.layer_norm = LayerNorm(out_features) if layer_norm else None

    def forward(self, x):
        x = self.mlp(x)
        return x if self.layer_norm is None else self.layer_norm(x)
