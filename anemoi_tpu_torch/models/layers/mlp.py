"""Feed-forward layers.

Port of ``anemoi_tpu.models.layers.mlp`` as the GraphTransformer uses it: one
hidden layer with the exact (erf) GELU -- torch.nn.GELU's default and the
JAX package's ``gelu`` (``nn.gelu(approximate=False)``), never the tanh
form.  Linear layers are laid out as anemoi-core's ``MLP.mlp`` Sequential
(``mlp.0`` the first Linear, ``mlp.2`` the second), so reference state-dict
names load as they are.  Extra hidden layers, other activations and the
gated (GLU-family) variants are not ported.
"""

from __future__ import annotations

from torch import nn

from anemoi_tpu_torch.models.layers.normalization import LayerNorm


def compute_mlp_hidden_dim(dim: int, ratio: float) -> int:
    return int(dim * ratio)


class FeedForwardLayer(nn.Sequential):
    """One hidden layer: Linear then exact GELU."""

    def __init__(self, in_features: int, out_features: int) -> None:
        super().__init__(nn.Linear(in_features, out_features), nn.GELU(approximate="none"))


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
