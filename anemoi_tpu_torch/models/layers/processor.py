"""Hidden-mesh processor.

Port of ``anemoi_tpu.models.layers.processor.GraphTransformerProcessor``.
The JAX package runs the layers as one ``nn.scan`` over stacked parameters;
here they are an ``nn.ModuleList`` (``proc.<i>``, anemoi-core's layout),
run in a Python loop.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from anemoi_tpu_torch.models.graph import SubGraphArrays
from anemoi_tpu_torch.models.layers.graph_blocks import GraphTransformerProcessorBlock
from anemoi_tpu_torch.models.layers.mlp import compute_mlp_hidden_dim


class GraphTransformerProcessor(nn.Module):
    """Stack of graph-transformer blocks over the hidden mesh."""

    def __init__(
        self, num_layers: int, num_channels: int, num_heads: int, edge_dim: int,
        mlp_hidden_ratio: float = 4.0, attn_channels: Optional[int] = None,
        qk_norm: bool = False, edge_pre_mlp: bool = False,
    ) -> None:
        super().__init__()
        hidden = compute_mlp_hidden_dim(num_channels, mlp_hidden_ratio)
        self.proc = nn.ModuleList(
            GraphTransformerProcessorBlock(
                num_channels, hidden, num_channels, num_heads, edge_dim,
                attn_channels=attn_channels, qk_norm=qk_norm, edge_pre_mlp=edge_pre_mlp,
            )
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, sub: SubGraphArrays, edge_attr: torch.Tensor) -> torch.Tensor:
        for block in self.proc:
            x = block(x, sub, edge_attr)
        return x
