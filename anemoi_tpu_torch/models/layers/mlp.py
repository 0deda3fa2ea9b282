"""Feed-forward layers.

Port of ``anemoi_tpu.models.layers.mlp``: a hidden layer, ``n_extra_layers``
more of the same width (the GNN's MLPs run ``mlp_extra_layers + 1``), and
the output Linear.  A hidden layer is either a Linear with its
``activation`` (any name of :data:`ACTIVATIONS`; by default the exact (erf)
GELU -- torch.nn.GELU's default and the JAX package's ``gelu``,
``nn.gelu(approximate=False)``) or, with ``implementation`` glu / swiglu /
geglu / reglu, the gated layer ``act(gate_proj(x)) * value_proj(x)`` with
act sigmoid / SiLU / tanh-GELU (flax's ``nn.gelu`` default) / ReLU, the JAX
package's ``GATING``.  ``final_activation`` applies ``activation`` again
after the output Linear, before the LayerNorm, as the JAX ``MLP`` does.
Linear layers are laid out as anemoi-core's ``MLP.mlp`` Sequential
(``mlp.0`` the hidden layer, ``mlp.2``, ``mlp.4``, ... the extra ones, the
output Linear last), so reference state-dict names load as they are; a
gated hidden layer keeps its ``gate_proj`` and ``value_proj`` under its
index.

The hidden activation is one ``torch.library`` op, :func:`mlp_hidden` (the
activation, or the gated product), so that a checkpoint policy sees it:
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


# the JAX package's ``ACTIVATIONS`` (the MLP's and the point-wise block's ``activation``)
ACTIVATIONS = {
    "gelu": F.gelu,
    "gelu_tanh": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
    "silu": F.silu,
    "swish": F.silu,
    "tanh": torch.tanh,
    "identity": lambda x: x,
}


def get_activation(name: str):
    if name not in ACTIVATIONS:
        raise ValueError(f"Unknown activation '{name}'. Known: {sorted(ACTIVATIONS)}")
    return ACTIVATIONS[name]


def _act(x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu":
        return F.gelu(x)
    if activation == "gelu_tanh":
        return F.gelu(x, approximate="tanh")
    if activation == "sigmoid":
        return torch.sigmoid(x)
    if activation in ("silu", "swish"):
        return F.silu(x)
    if activation == "relu":
        return F.relu(x)
    if activation == "tanh":
        return torch.tanh(x)
    if activation == "identity":
        return x.clone()  # an op's output may not alias its input
    raise ValueError(f"unknown activation '{activation}'")


def _act_backward(grad: torch.Tensor, x: torch.Tensor, activation: str) -> torch.Tensor:
    if activation == "gelu":
        return torch.ops.aten.gelu_backward(grad, x)
    if activation == "gelu_tanh":
        return torch.ops.aten.gelu_backward(grad, x, approximate="tanh")
    if activation == "sigmoid":
        s = torch.sigmoid(x)
        return grad * s * (1 - s)
    if activation in ("silu", "swish"):
        return torch.ops.aten.silu_backward(grad, x)
    if activation == "tanh":
        return torch.ops.aten.tanh_backward(grad, torch.tanh(x))
    if activation == "identity":
        return grad
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


class HiddenActivation(nn.Module):
    """The plain hidden layer's activation through :func:`mlp_hidden`."""

    def __init__(self, activation: str = "gelu") -> None:
        super().__init__()
        get_activation(activation)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_hidden(x, None, self.activation)


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


def feed_forward(in_features: int, out_features: int, implementation: str = "mlp",
                 activation: str = "gelu"):
    """The hidden layer as two Sequential entries: Linear then ``activation``,
    or the gated layer (whose activation is its ``GATING`` one, as in the JAX
    package) then nothing (keeping the output Linear at ``mlp.2``)."""
    if implementation == "mlp":
        return nn.Linear(in_features, out_features), HiddenActivation(activation)
    return GatedFeedForward(in_features, out_features, implementation), nn.Identity()


class MLP(nn.Module):
    """in -> hidden layer (``implementation``, ``activation``) ->
    ``n_extra_layers`` more -> out, then ``activation`` again with
    ``final_activation``, and an optional trailing LayerNorm."""

    def __init__(self, in_features: int, hidden_dim: int, out_features: int,
                 layer_norm: bool = True, implementation: str = "mlp",
                 n_extra_layers: int = 0, activation: str = "gelu",
                 final_activation: bool = False) -> None:
        super().__init__()
        self.mlp = nn.Sequential(
            *feed_forward(in_features, hidden_dim, implementation, activation),
            *(layer for _ in range(n_extra_layers)
              for layer in feed_forward(hidden_dim, hidden_dim, implementation, activation)),
            nn.Linear(hidden_dim, out_features),
        )
        self.final_activation = get_activation(activation) if final_activation else None
        self.layer_norm = LayerNorm(out_features) if layer_norm else None

    def finish(self, x: torch.Tensor) -> torch.Tensor:
        """What follows the output Linear: the final activation and the
        LayerNorm, each where the MLP has it."""
        if self.final_activation is not None:
            x = self.final_activation(x)
        return x if self.layer_norm is None else self.layer_norm(x)

    def forward(self, x):
        return self.finish(self.mlp(x))
