"""Grid <-> mesh graph-transformer mappers.

Port of ``anemoi_tpu.models.layers.mapper`` (``TrainableEdgeFeatures``,
``GraphTransformerForwardMapper``, ``GraphTransformerBackwardMapper``).
A mapper = node embeddings + one bipartite block + (decoder) the output
extractor.  ``gradient_checkpointing`` (default off, as in the JAX package)
checkpoints the block alone under ``remat_policy``; the node embeddings and
the trainable edge features stay outside.  The mappers take no conditioning:
the JAX model passes none to them, so their blocks' norms are plain; their
query/key norm is the default LayerNorm (the JAX mappers have no
``qk_norm_type``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from anemoi_tpu_torch.models.graph import SubGraphArrays
from anemoi_tpu_torch.models.layers.graph_blocks import GraphTransformerMapperBlock
from anemoi_tpu_torch.models.layers.mlp import compute_mlp_hidden_dim
from anemoi_tpu_torch.models.layers.normalization import LayerNorm
from anemoi_tpu_torch.models.layers.remat import BlockRemat


class TrainableEdgeFeatures(nn.Module):
    """Zero-initialised trainable per-edge features ``trainable [E, size]``
    appended to the static edge attributes.  Like anemoi-core, the model
    keeps one per sub-graph on its graph providers
    (``encoder_graph_provider.<dataset>.trainable``)."""

    def __init__(self, num_edges: int, trainable_size: int) -> None:
        super().__init__()
        self.trainable = nn.Parameter(torch.zeros(num_edges, trainable_size))

    def forward(self, edge_attr: torch.Tensor) -> torch.Tensor:
        return torch.cat([edge_attr, self.trainable.to(edge_attr.dtype)], dim=-1)


def _block(in_channels, hidden_dim, num_heads, edge_dim, mlp_hidden_ratio, **block_kw):
    return GraphTransformerMapperBlock(
        in_channels, compute_mlp_hidden_dim(hidden_dim, mlp_hidden_ratio), hidden_dim,
        num_heads, edge_dim, **block_kw,
    )


class GraphTransformerForwardMapper(BlockRemat, nn.Module):
    """data -> hidden encoder.  Returns ``(x[0], latent)``: the RAW source
    input, not its embedding -- the decoder re-embeds it with its own
    ``emb_nodes_dst``."""

    def __init__(
        self, in_channels_src: int, in_channels_dst: int, hidden_dim: int, num_heads: int,
        edge_dim: int, mlp_hidden_ratio: float = 4.0, attn_channels: Optional[int] = None,
        qk_norm: bool = False, edge_pre_mlp: bool = False, mlp_implementation: str = "mlp",
        gradient_checkpointing: bool = False, remat_policy: Optional[str] = "save_attention",
    ) -> None:
        super().__init__()
        self._init_remat(gradient_checkpointing, remat_policy)
        self.emb_nodes_src = nn.Linear(in_channels_src, hidden_dim)
        self.emb_nodes_dst = nn.Linear(in_channels_dst, hidden_dim)
        self.proc = _block(hidden_dim, hidden_dim, num_heads, edge_dim, mlp_hidden_ratio,
                           attn_channels=attn_channels, qk_norm=qk_norm,
                           edge_pre_mlp=edge_pre_mlp, mlp_implementation=mlp_implementation)

    def forward(
        self, x: Tuple[torch.Tensor, torch.Tensor], sub: SubGraphArrays, edge_attr: torch.Tensor,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x_src = self.emb_nodes_src(x[0])
        x_dst = self.emb_nodes_dst(x[1])
        _, x_dst = self._run(self.proc, (x_src, x_dst), sub, edge_attr)
        return x[0], x_dst


class GraphTransformerBackwardMapper(BlockRemat, nn.Module):
    """hidden -> data decoder: embed the data nodes' raw input, attend from
    the mesh, then ``node_data_extractor`` = LayerNorm -> Linear(out)."""

    def __init__(
        self, in_channels_dst: int, hidden_dim: int, out_channels_dst: int, num_heads: int,
        edge_dim: int, mlp_hidden_ratio: float = 4.0, attn_channels: Optional[int] = None,
        qk_norm: bool = False, edge_pre_mlp: bool = False, mlp_implementation: str = "mlp",
        gradient_checkpointing: bool = False, remat_policy: Optional[str] = "save_attention",
    ) -> None:
        super().__init__()
        self._init_remat(gradient_checkpointing, remat_policy)
        self.emb_nodes_dst = nn.Linear(in_channels_dst, hidden_dim)
        self.proc = _block(hidden_dim, hidden_dim, num_heads, edge_dim, mlp_hidden_ratio,
                           attn_channels=attn_channels, qk_norm=qk_norm,
                           edge_pre_mlp=edge_pre_mlp, mlp_implementation=mlp_implementation)
        self.node_data_extractor = nn.Sequential(
            LayerNorm(hidden_dim), nn.Linear(hidden_dim, out_channels_dst)
        )

    def forward(
        self, x: Tuple[torch.Tensor, torch.Tensor], sub: SubGraphArrays, edge_attr: torch.Tensor,
    ) -> torch.Tensor:
        x_dst = self.emb_nodes_dst(x[1])
        _, x_dst = self._run(self.proc, (x[0], x_dst), sub, edge_attr)
        norm, head = self.node_data_extractor
        out = norm(x_dst)
        # a float32 head under bf16 compute (training's fp32_head) promotes its
        # input, as the JAX package's Dense does
        return head(out.to(torch.promote_types(out.dtype, head.weight.dtype)))
