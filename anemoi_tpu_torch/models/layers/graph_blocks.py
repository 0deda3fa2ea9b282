"""Graph-transformer blocks.

Port of ``anemoi_tpu.models.layers.graph_blocks`` (``GraphTransformerAttention``,
``GraphTransformerMapperBlock``, ``GraphTransformerProcessorBlock``).  The
attention projections (``lin_query``, ``lin_key``, ``lin_value``,
``lin_edge``) sit directly on the block, as in anemoi-core, so reference
state-dict names load as they are.  Node features are ``[B, N, C]``; the edge
features of a sub-graph are shared over the batch.

The sparse attention runs through ``anemoi_tpu_torch.ops.gt_attention``:
without an ``edge_pre_mlp`` the ``lin_edge`` projection is fused into the
kernel (K1, the flagship path); with one, ``lin_edge`` runs first and the
projected edges go to K2.  The backward takes the edge set's source-ordered
view and its ``fused_bwd`` choice (K3 + K4, or K3 + K5).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from anemoi_tpu_torch.models.graph import SubGraphArrays
from anemoi_tpu_torch.models.layers.mlp import MLP
from anemoi_tpu_torch.models.layers.normalization import LayerNorm, QKNorm
from anemoi_tpu_torch.ops.gt_attention import gt_attention, gt_attention_fe


class GraphTransformerBaseBlock(nn.Module):
    """The q/k/v/edge projections and the sparse attention shared by the
    mapper and processor blocks (the JAX ``GraphTransformerAttention``).

    ``plain_attention`` selects the plain PyTorch attention instead of the
    CUDA kernel; it exists so that a run on the card can be compared with the
    same model on the plain version."""

    def __init__(
        self, in_channels: int, hidden_dim: int, out_channels: int, num_heads: int,
        edge_dim: int, attn_channels: Optional[int] = None, qk_norm: bool = False,
        edge_pre_mlp: bool = False,
    ) -> None:
        super().__init__()
        hd = attn_channels or out_channels
        if hd % num_heads:
            raise ValueError(f"attn_channels {hd} not divisible by num_heads {num_heads}")
        self.num_heads = num_heads
        self.attn_channels = hd
        self.lin_key = nn.Linear(in_channels, hd)
        self.lin_query = nn.Linear(in_channels, hd)
        self.lin_value = nn.Linear(in_channels, hd)
        self.lin_self = nn.Linear(in_channels, hd)
        self.lin_edge = nn.Linear(edge_dim, hd)
        self.projection = nn.Linear(hd, out_channels)
        self.q_norm = QKNorm(hd // num_heads) if qk_norm else None
        self.k_norm = QKNorm(hd // num_heads) if qk_norm else None
        self.edge_pre_mlp = (
            MLP(edge_dim, edge_dim, edge_dim, layer_norm=False) if edge_pre_mlp else None
        )
        self.node_dst_mlp = MLP(out_channels, hidden_dim, out_channels, layer_norm=False)
        self.plain_attention = False

    def _head_norm(self, norm: nn.Module, x: torch.Tensor) -> torch.Tensor:
        b, n, hd = x.shape
        return norm(x.view(b, n, self.num_heads, hd // self.num_heads)).view(b, n, hd)

    def attention(
        self, x_src: torch.Tensor, x_dst: torch.Tensor, sub: SubGraphArrays,
        edge_attr: torch.Tensor,
    ) -> torch.Tensor:
        query = self.lin_query(x_dst)
        key = self.lin_key(x_src)
        value = self.lin_value(x_src)
        if self.q_norm is not None:
            query = self._head_norm(self.q_norm, query)
            key = self._head_norm(self.k_norm, key)
        e = edge_attr.to(x_src.dtype)
        if self.edge_pre_mlp is None:
            out, _ = gt_attention_fe(
                query, key, value, e, self.lin_edge.weight.t(), self.lin_edge.bias,
                sub.edge_index, sub.dst_ptr, self.num_heads, plain=self.plain_attention,
                source=sub.source, fused_bwd=sub.fused_bwd,
            )
        else:
            edges = self.lin_edge(self.edge_pre_mlp(e))
            out, _ = gt_attention(
                query, key, value, edges, sub.edge_index, sub.dst_ptr, self.num_heads,
                plain=self.plain_attention, source=sub.source, fused_bwd=sub.fused_bwd,
            )
        return out


class GraphTransformerMapperBlock(GraphTransformerBaseBlock):
    """Bipartite graph-transformer block (source nodes are not updated)."""

    def __init__(self, in_channels: int, hidden_dim: int, out_channels: int, num_heads: int,
                 edge_dim: int, **kwargs) -> None:
        super().__init__(in_channels, hidden_dim, out_channels, num_heads, edge_dim, **kwargs)
        self.layer_norm_attention_src = LayerNorm(in_channels)
        self.layer_norm_attention_dest = LayerNorm(in_channels)
        self.layer_norm_mlp_dst = LayerNorm(out_channels)

    def forward(
        self, x: Tuple[torch.Tensor, torch.Tensor], sub: SubGraphArrays,
        edge_attr: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x_src = self.layer_norm_attention_src(x[0])
        x_dst = self.layer_norm_attention_dest(x[1])
        x_r = self.lin_self(x_dst)
        out = self.attention(x_src, x_dst, sub, edge_attr)
        out = self.projection(out + x_r) + x[1]
        out = self.node_dst_mlp(self.layer_norm_mlp_dst(out)) + out
        return x[0], out


class GraphTransformerProcessorBlock(GraphTransformerBaseBlock):
    """Homogeneous graph-transformer block over the hidden mesh."""

    def __init__(self, in_channels: int, hidden_dim: int, out_channels: int, num_heads: int,
                 edge_dim: int, **kwargs) -> None:
        super().__init__(in_channels, hidden_dim, out_channels, num_heads, edge_dim, **kwargs)
        self.layer_norm_attention = LayerNorm(in_channels)
        self.layer_norm_mlp_dst = LayerNorm(out_channels)

    def forward(self, x: torch.Tensor, sub: SubGraphArrays, edge_attr: torch.Tensor) -> torch.Tensor:
        x_n = self.layer_norm_attention(x)
        x_r = self.lin_self(x_n)
        out = self.attention(x_n, x_n, sub, edge_attr)
        out = self.projection(out + x_r) + x
        return self.node_dst_mlp(self.layer_norm_mlp_dst(out)) + out
