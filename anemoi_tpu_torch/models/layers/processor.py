"""Hidden-mesh processors.

Port of ``anemoi_tpu.models.layers.processor``: ``GraphTransformerProcessor``,
the dense ``TransformerProcessor`` (with ``TransformerProcessorBlock``),
``GNNProcessor`` and ``PointWiseMLPProcessor``.
The JAX package runs the layers as one ``nn.scan`` over stacked parameters;
here they are an ``nn.ModuleList`` (``proc.<i>``, anemoi-core's layout),
run in a Python loop.  ``gradient_checkpointing`` (default on) checkpoints
each block under ``remat_policy`` (default ``save_attention``), as the JAX
package remats its scan body of one block; only while autograd records, so
forecasts and evaluation run as before.  ``scan_layers`` has no counterpart;
``scan_unroll`` (blocks per scan iteration) changes only the JAX package's
parameter stacking, which ``state_dict_from_jax`` undoes.  The conditioning
``cond`` (``[B·M, N, cond_dim]``, the ensemble's noise conditioning) goes
to every block, an input of each block's checkpoint as its parameters are.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from anemoi_tpu_torch.models.graph import SubGraphArrays
from anemoi_tpu_torch.models.layers.attention import MultiHeadSelfAttention
from anemoi_tpu_torch.models.layers.graph_blocks import (
    GraphConvProcessorBlock,
    GraphTransformerProcessorBlock,
    PointWiseMLPBlock,
)
from anemoi_tpu_torch.models.layers.mlp import MLP, compute_mlp_hidden_dim
from anemoi_tpu_torch.models.layers.normalization import norm
from anemoi_tpu_torch.models.layers.remat import BlockRemat


class GraphTransformerProcessor(BlockRemat, nn.Module):
    """Stack of graph-transformer blocks over the hidden mesh."""

    def __init__(
        self, num_layers: int, num_channels: int, num_heads: int, edge_dim: int,
        mlp_hidden_ratio: float = 4.0, attn_channels: Optional[int] = None,
        qk_norm: bool = False, edge_pre_mlp: bool = False, mlp_implementation: str = "mlp",
        cond_dim: Optional[int] = None, scan_unroll: int = 1,
        gradient_checkpointing: bool = True, remat_policy: Optional[str] = "save_attention",
    ) -> None:
        super().__init__()
        if num_layers % max(int(scan_unroll), 1):
            raise ValueError(f"scan_unroll {scan_unroll} must divide num_layers {num_layers}")
        self._init_remat(gradient_checkpointing, remat_policy)
        hidden = compute_mlp_hidden_dim(num_channels, mlp_hidden_ratio)
        self.proc = nn.ModuleList(
            GraphTransformerProcessorBlock(
                num_channels, hidden, num_channels, num_heads, edge_dim,
                attn_channels=attn_channels, qk_norm=qk_norm, edge_pre_mlp=edge_pre_mlp,
                mlp_implementation=mlp_implementation, cond_dim=cond_dim,
            )
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, sub: SubGraphArrays, edge_attr: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.proc:
            x = self._run(block, x, sub, edge_attr, cond)
        return x


class TransformerProcessorBlock(nn.Module):
    """Dense pre-norm transformer block with sliding-window MHSA:
    ``x + attention(layer_norm_attention(x))``, then ``x + mlp(layer_norm_mlp(x))``."""

    def __init__(self, num_channels: int, hidden_dim: int, num_heads: int,
                 mlp_implementation: str = "mlp", cond_dim: Optional[int] = None,
                 **attention_kw) -> None:
        super().__init__()
        self.layer_norm_attention = norm(num_channels, cond_dim)
        self.attention = MultiHeadSelfAttention(num_channels, num_heads, **attention_kw)
        self.layer_norm_mlp = norm(num_channels, cond_dim)
        self.mlp = MLP(num_channels, hidden_dim, num_channels, layer_norm=False,
                       implementation=mlp_implementation)

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = x + self.attention(self.layer_norm_attention(x, cond))
        return x + self.mlp(self.layer_norm_mlp(x, cond))


class TransformerProcessor(BlockRemat, nn.Module):
    """Stack of dense sliding-window transformer blocks over the hidden
    nodes, in their (space-filling-curve) order; the processor edges are
    not read."""

    def __init__(
        self, num_layers: int, num_channels: int, num_heads: int,
        mlp_hidden_ratio: float = 4.0, gradient_checkpointing: bool = True,
        remat_policy: Optional[str] = "save_attention", **attention_kw,
    ) -> None:
        super().__init__()
        self._init_remat(gradient_checkpointing, remat_policy)
        hidden = compute_mlp_hidden_dim(num_channels, mlp_hidden_ratio)
        self.proc = nn.ModuleList(
            TransformerProcessorBlock(num_channels, hidden, num_heads, **attention_kw)
            for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.proc:
            x = self._run(block, x, cond)
        return x


class GNNProcessor(BlockRemat, nn.Module):
    """Stack of GNN blocks over the hidden mesh; the first embeds the raw
    edge attributes, the updated edge features thread through the rest."""

    def __init__(
        self, num_layers: int, num_channels: int, edge_dim: int, mlp_extra_layers: int = 0,
        mlp_hidden_ratio: float = 1.0, mlp_implementation: str = "mlp",
        gradient_checkpointing: bool = True, remat_policy: Optional[str] = "save_attention",
    ) -> None:
        super().__init__()
        self._init_remat(gradient_checkpointing, remat_policy)
        kw = dict(mlp_extra_layers=mlp_extra_layers, mlp_hidden_ratio=mlp_hidden_ratio,
                  mlp_implementation=mlp_implementation)
        self.proc = nn.ModuleList(
            GraphConvProcessorBlock(num_channels, edge_dim=edge_dim if i == 0 else None, **kw)
            for i in range(num_layers)
        )

    def forward(self, x: torch.Tensor, sub: SubGraphArrays, edge_attr: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.proc:
            x, edge_attr = self._run(block, x, edge_attr, sub)
        return x


class PointWiseMLPProcessor(nn.Module):
    """Stack of point-wise MLP blocks; no message passing."""

    def __init__(self, num_layers: int, num_channels: int, mlp_hidden_ratio: float = 1.0,
                 activation: str = "gelu") -> None:
        super().__init__()
        hidden = compute_mlp_hidden_dim(num_channels, mlp_hidden_ratio)
        self.proc = nn.ModuleList(
            PointWiseMLPBlock(num_channels, hidden, activation) for _ in range(num_layers)
        )

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        for block in self.proc:
            x = block(x)
        return x
