"""Grid <-> mesh mappers: graph-transformer, GNN and point-wise.

Port of ``anemoi_tpu.models.layers.mapper`` (``TrainableEdgeFeatures``,
``GraphTransformerForwardMapper``, ``GraphTransformerBackwardMapper``,
``GNNForwardMapper``, ``GNNBackwardMapper``, ``PointWiseForwardMapper``,
``PointWiseBackwardMapper``, ``TransformerForwardMapper``,
``TransformerBackwardMapper``).
A mapper = node embeddings + one bipartite block + (decoder) the output
extractor.  ``gradient_checkpointing`` (default off, as in the JAX package)
checkpoints the block alone under ``remat_policy``; the node embeddings and
the trainable edge features stay outside.  The graph-transformer mappers
take the conditioning ``cond = (cond_src, cond_dst)`` of a transport model
with conditional mappers: built with ``cond_dim``, every norm of their block
is a ``ConditionalLayerNorm``; without it (every other model) the norms are
plain.  Their query/key norm is the default LayerNorm (the JAX mappers have
no ``qk_norm_type``).  The GNN and point-wise mappers accept ``cond_dim``
and ``cond`` and ignore them, as the JAX ones do.

The GNN mappers embed the edges (``emb_edges``) and, in the encoder, both
node sets (``emb_nodes_src``, ``emb_nodes_dst``) with MLPs, then run one
``GraphConvMapperBlock``; every one of their MLPs runs ``mlp_extra_layers +
1`` extra hidden layers, as the JAX mappers do.  The GNN encoder returns the
UPDATED source nodes, which the decoder takes as its destinations; its
``node_data_extractor`` is an MLP.  The point-wise mappers are one MLP over
``[x_src, x_dst]`` and need equal source and destination node counts; they
read no edges.  The Transformer mappers embed their nodes and run one
``TransformerMapperBlock``: dense cross attention of every destination over
every source (``MultiHeadCrossAttention``, flash / memory-efficient SDPA on
the card), then an MLP, each behind a LayerNorm and a residual; they read no
edges and carry no trainable edge features, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from anemoi_tpu_torch.models.graph import SubGraphArrays
from anemoi_tpu_torch.models.layers.attention import MultiHeadCrossAttention
from anemoi_tpu_torch.models.layers.graph_blocks import (
    GraphConvMapperBlock,
    GraphTransformerMapperBlock,
    gnn_mlp,
)
from anemoi_tpu_torch.models.layers.mlp import MLP, compute_mlp_hidden_dim
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
        cond_dim: Optional[int] = None,
    ) -> None:
        super().__init__()
        self._init_remat(gradient_checkpointing, remat_policy)
        self.emb_nodes_src = nn.Linear(in_channels_src, hidden_dim)
        self.emb_nodes_dst = nn.Linear(in_channels_dst, hidden_dim)
        self.proc = _block(hidden_dim, hidden_dim, num_heads, edge_dim, mlp_hidden_ratio,
                           attn_channels=attn_channels, qk_norm=qk_norm,
                           edge_pre_mlp=edge_pre_mlp, mlp_implementation=mlp_implementation,
                           cond_dim=cond_dim)

    def forward(
        self, x: Tuple[torch.Tensor, torch.Tensor], sub: SubGraphArrays, edge_attr: torch.Tensor,
        cond: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        x_src = self.emb_nodes_src(x[0])
        x_dst = self.emb_nodes_dst(x[1])
        _, x_dst = self._run(self.proc, (x_src, x_dst), sub, edge_attr, cond)
        return x[0], x_dst


class GraphTransformerBackwardMapper(BlockRemat, nn.Module):
    """hidden -> data decoder: embed the data nodes' raw input, attend from
    the mesh, then ``node_data_extractor`` = LayerNorm -> Linear(out)."""

    def __init__(
        self, in_channels_dst: int, hidden_dim: int, out_channels_dst: int, num_heads: int,
        edge_dim: int, mlp_hidden_ratio: float = 4.0, attn_channels: Optional[int] = None,
        qk_norm: bool = False, edge_pre_mlp: bool = False, mlp_implementation: str = "mlp",
        gradient_checkpointing: bool = False, remat_policy: Optional[str] = "save_attention",
        cond_dim: Optional[int] = None,
    ) -> None:
        super().__init__()
        self._init_remat(gradient_checkpointing, remat_policy)
        self.emb_nodes_dst = nn.Linear(in_channels_dst, hidden_dim)
        self.proc = _block(hidden_dim, hidden_dim, num_heads, edge_dim, mlp_hidden_ratio,
                           attn_channels=attn_channels, qk_norm=qk_norm,
                           edge_pre_mlp=edge_pre_mlp, mlp_implementation=mlp_implementation,
                           cond_dim=cond_dim)
        self.node_data_extractor = nn.Sequential(
            LayerNorm(hidden_dim), nn.Linear(hidden_dim, out_channels_dst)
        )

    @property
    def output_linear(self) -> nn.Linear:
        """The output head's Linear (zero with ``initialise_data_extractor_zero``)."""
        return self.node_data_extractor[1]

    def forward(
        self, x: Tuple[torch.Tensor, torch.Tensor], sub: SubGraphArrays, edge_attr: torch.Tensor,
        cond: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> torch.Tensor:
        x_dst = self.emb_nodes_dst(x[1])
        _, x_dst = self._run(self.proc, (x[0], x_dst), sub, edge_attr, cond)
        norm, head = self.node_data_extractor
        out = norm(x_dst)
        return head(_promoted(out, head.weight))


def _promoted(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """A float32 head under bf16 compute (training's fp32_head) promotes its
    input, as the JAX package's Dense does."""
    return x.to(torch.promote_types(x.dtype, weight.dtype))


def _broadcast_edges(mlp: nn.Module, edge_attr: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The edge embedding ``mlp(edge_attr)`` in ``like``'s type, shared by
    its batch: ``[B, E, C]``."""
    emb = mlp(edge_attr.to(like.dtype))
    return emb.expand((like.shape[0],) + emb.shape)


class GNNForwardMapper(nn.Module):
    """GNN data -> hidden encoder: returns the updated ``(x_src, x_dst)``
    embeddings."""

    def __init__(self, in_channels_src: int, in_channels_dst: int, hidden_dim: int,
                 edge_dim: int, mlp_extra_layers: int = 0,
                 mlp_implementation: str = "mlp", cond_dim: Optional[int] = None) -> None:
        super().__init__()
        c, kw = hidden_dim, dict(mlp_extra_layers=mlp_extra_layers,
                                 implementation=mlp_implementation)
        self.emb_edges = gnn_mlp(edge_dim, c, c, **kw)
        self.emb_nodes_src = gnn_mlp(in_channels_src, c, c, **kw)
        self.emb_nodes_dst = gnn_mlp(in_channels_dst, c, c, **kw)
        self.proc = GraphConvMapperBlock(c, mlp_extra_layers, update_src_nodes=True,
                                         mlp_implementation=mlp_implementation)

    def forward(
        self, x: Tuple[torch.Tensor, torch.Tensor], sub: SubGraphArrays, edge_attr: torch.Tensor,
        cond=None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        edges = _broadcast_edges(self.emb_edges, edge_attr, x[0])
        x = (self.emb_nodes_src(x[0]), self.emb_nodes_dst(x[1]))
        return self.proc(x, edges, sub)[0]


class GNNBackwardMapper(nn.Module):
    """GNN hidden -> data decoder: the block onto the data nodes (the
    encoder's updated embeddings), then ``node_data_extractor``, an MLP."""

    def __init__(self, in_channels_dst: int, hidden_dim: int, out_channels_dst: int,
                 edge_dim: int, mlp_extra_layers: int = 0,
                 mlp_implementation: str = "mlp", cond_dim: Optional[int] = None) -> None:
        super().__init__()
        c, kw = hidden_dim, dict(mlp_extra_layers=mlp_extra_layers,
                                 implementation=mlp_implementation)
        self.emb_edges = gnn_mlp(edge_dim, c, c, **kw)
        self.proc = GraphConvMapperBlock(c, mlp_extra_layers, update_src_nodes=False,
                                         mlp_implementation=mlp_implementation)
        self.node_data_extractor = gnn_mlp(c, c, out_channels_dst, layer_norm=False, **kw)

    @property
    def output_linear(self) -> nn.Linear:
        return self.node_data_extractor.mlp[-1]

    def forward(
        self, x: Tuple[torch.Tensor, torch.Tensor], sub: SubGraphArrays, edge_attr: torch.Tensor,
        cond=None,
    ) -> torch.Tensor:
        edges = _broadcast_edges(self.emb_edges, edge_attr, x[0])
        (_, x_dst), _ = self.proc(x, edges, sub)
        return self.node_data_extractor(_promoted(x_dst, self.output_linear.weight))


def _same_nodes(x_src: torch.Tensor, x_dst: torch.Tensor) -> None:
    if x_src.shape[1] != x_dst.shape[1]:
        raise ValueError("PointWise mappers require matching src/dst node sets, got "
                         f"{x_src.shape[1]} and {x_dst.shape[1]} nodes")


class PointWiseForwardMapper(nn.Module):
    """Point-wise encoder: ``mlp([x_src, x_dst])`` per node (LayerNorm
    last); returns ``(x_src, latent)``."""

    def __init__(self, in_channels_src: int, in_channels_dst: int, hidden_dim: int,
                 edge_dim: int = 0, mlp_hidden_ratio: float = 1.0,
                 cond_dim: Optional[int] = None) -> None:
        super().__init__()
        self.mlp = MLP(in_channels_src + in_channels_dst,
                       compute_mlp_hidden_dim(hidden_dim, mlp_hidden_ratio), hidden_dim)

    def forward(self, x: Tuple[torch.Tensor, torch.Tensor], sub=None, edge_attr=None, cond=None):
        _same_nodes(*x)
        return x[0], self.mlp(torch.cat(x, dim=-1))


class PointWiseBackwardMapper(nn.Module):
    """Point-wise decoder: ``mlp([x_src, x_dst])`` per node, no LayerNorm."""

    def __init__(self, in_channels_dst: int, hidden_dim: int, out_channels_dst: int,
                 edge_dim: int = 0, mlp_hidden_ratio: float = 1.0,
                 cond_dim: Optional[int] = None) -> None:
        super().__init__()
        self.mlp = MLP(hidden_dim + in_channels_dst,
                       compute_mlp_hidden_dim(hidden_dim, mlp_hidden_ratio), out_channels_dst,
                       layer_norm=False)

    @property
    def output_linear(self) -> nn.Linear:
        return self.mlp.mlp[-1]

    def forward(self, x: Tuple[torch.Tensor, torch.Tensor], sub=None, edge_attr=None, cond=None):
        _same_nodes(*x)
        return self.mlp(torch.cat(x, dim=-1))


class TransformerMapperBlock(nn.Module):
    """``x_dst + attention(LN(x_src), LN(x_dst))``, then ``+ mlp(LN(.))``
    (anemoi-core's names; the JAX mapper's ``ln_src``, ``ln_dst``,
    ``cross_attention``, ``ln_mlp`` and ``mlp``)."""

    def __init__(self, hidden_dim: int, num_heads: int, mlp_hidden_ratio: float) -> None:
        super().__init__()
        self.layer_norm_attention_src = LayerNorm(hidden_dim)
        self.layer_norm_attention_dst = LayerNorm(hidden_dim)
        self.attention = MultiHeadCrossAttention(hidden_dim, num_heads)
        self.layer_norm_mlp = LayerNorm(hidden_dim)
        self.mlp = MLP(hidden_dim, compute_mlp_hidden_dim(hidden_dim, mlp_hidden_ratio),
                       hidden_dim, layer_norm=False)

    def forward(self, x_src: torch.Tensor, x_dst: torch.Tensor) -> torch.Tensor:
        x_dst = x_dst + self.attention(self.layer_norm_attention_src(x_src),
                                       self.layer_norm_attention_dst(x_dst))
        return x_dst + self.mlp(self.layer_norm_mlp(x_dst))


class TransformerForwardMapper(nn.Module):
    """Dense cross-attention encoder (data -> hidden): every hidden node
    attends to every data node.  Returns ``(x[0], latent)``, as the
    graph-transformer encoder does."""

    def __init__(self, in_channels_src: int, in_channels_dst: int, hidden_dim: int,
                 num_heads: int, edge_dim: int = 0, mlp_hidden_ratio: float = 4.0,
                 cond_dim: Optional[int] = None) -> None:
        super().__init__()
        self.emb_nodes_src = nn.Linear(in_channels_src, hidden_dim)
        self.emb_nodes_dst = nn.Linear(in_channels_dst, hidden_dim)
        self.proc = TransformerMapperBlock(hidden_dim, num_heads, mlp_hidden_ratio)

    def forward(self, x: Tuple[torch.Tensor, torch.Tensor], sub=None, edge_attr=None, cond=None):
        return x[0], self.proc(self.emb_nodes_src(x[0]), self.emb_nodes_dst(x[1]))


class TransformerBackwardMapper(nn.Module):
    """Dense cross-attention decoder (hidden -> data), then
    ``node_data_extractor`` = LayerNorm -> Linear(out)."""

    def __init__(self, in_channels_dst: int, hidden_dim: int, out_channels_dst: int,
                 num_heads: int, edge_dim: int = 0, mlp_hidden_ratio: float = 4.0,
                 cond_dim: Optional[int] = None) -> None:
        super().__init__()
        self.emb_nodes_dst = nn.Linear(in_channels_dst, hidden_dim)
        self.proc = TransformerMapperBlock(hidden_dim, num_heads, mlp_hidden_ratio)
        self.node_data_extractor = nn.Sequential(
            LayerNorm(hidden_dim), nn.Linear(hidden_dim, out_channels_dst)
        )

    @property
    def output_linear(self) -> nn.Linear:
        return self.node_data_extractor[1]

    def forward(self, x: Tuple[torch.Tensor, torch.Tensor], sub=None, edge_attr=None, cond=None):
        x_dst = self.proc(x[0], self.emb_nodes_dst(x[1]))
        norm, head = self.node_data_extractor
        return head(_promoted(norm(x_dst), head.weight))
