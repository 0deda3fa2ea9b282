"""Feed-forward layers.

Port of ``anemoi_tpu.models.layers.mlp`` as the GraphTransformer uses it: one
hidden layer with the exact (erf) GELU -- torch.nn.GELU's default and the
JAX package's ``gelu`` (``nn.gelu(approximate=False)``), never the tanh
form.  Linear layers are laid out as anemoi-core's ``MLP.mlp`` Sequential
(``mlp.0`` the first Linear, ``mlp.2`` the second), so reference state-dict
names load as they are.  Extra hidden layers, other activations and the
gated (GLU-family) variants are not ported.

The hidden activation is one ``torch.library`` op, :func:`mlp_hidden` (the
GELU), so that a checkpoint policy sees it: ``save_attention_mlp``
(``models/layers/remat.py``) keeps its ``[N, ratio * C]`` output, as the JAX
package keeps the activation it tags ``mlp_hidden``.
"""

from __future__ import annotations

import torch
from torch import nn

from anemoi_tpu_torch.models.layers.normalization import LayerNorm


def compute_mlp_hidden_dim(dim: int, ratio: float) -> int:
    return int(dim * ratio)


@torch.library.custom_op("anemoi_tpu_torch::mlp_hidden", mutates_args=())
def mlp_hidden(x: torch.Tensor) -> torch.Tensor:
    """The exact GELU of the hidden layer, as an op a checkpoint policy can
    name; its gradient is autograd's own ``gelu_backward``."""
    return nn.functional.gelu(x)


@mlp_hidden.register_fake
def _(x):
    return torch.empty_like(x)


def _mlp_hidden_setup_context(ctx, inputs, output):
    ctx.save_for_backward(inputs[0])


def _mlp_hidden_backward(ctx, grad):
    (x,) = ctx.saved_tensors
    return torch.ops.aten.gelu_backward(grad, x)


mlp_hidden.register_autograd(_mlp_hidden_backward, setup_context=_mlp_hidden_setup_context)


class HiddenGELU(nn.Module):
    """Exact GELU through :func:`mlp_hidden`."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return mlp_hidden(x)


class FeedForwardLayer(nn.Sequential):
    """One hidden layer: Linear then exact GELU."""

    def __init__(self, in_features: int, out_features: int) -> None:
        super().__init__(nn.Linear(in_features, out_features), HiddenGELU())


class MLP(nn.Module):
    """in -> hidden (exact GELU) -> out, with an optional trailing LayerNorm."""

    def __init__(self, in_features: int, hidden_dim: int, out_features: int,
                 layer_norm: bool = True) -> None:
        super().__init__()
        self.mlp = nn.Sequential(
            *FeedForwardLayer(in_features, hidden_dim), nn.Linear(hidden_dim, out_features)
        )
        self.layer_norm = LayerNorm(out_features) if layer_norm else None

    def forward(self, x):
        x = self.mlp(x)
        return x if self.layer_norm is None else self.layer_norm(x)
