"""Graph blocks: graph-transformer, GNN and point-wise.

Port of ``anemoi_tpu.models.layers.graph_blocks`` (``GraphTransformerAttention``,
``GraphTransformerMapperBlock``, ``GraphTransformerProcessorBlock``,
``GraphConv``, ``GraphConvProcessorBlock``, ``GraphConvMapperBlock``,
``PointWiseMLPBlock``).  The
attention projections (``lin_query``, ``lin_key``, ``lin_value``,
``lin_edge``) sit directly on the block, as in anemoi-core, so reference
state-dict names load as they are.  Node features are ``[B, N, C]``; the edge
features of a sub-graph are shared over the batch.

The sparse attention runs through ``anemoi_tpu_torch.ops.gt_attention``:
without an ``edge_pre_mlp`` the ``lin_edge`` projection is fused into the
kernel (K1, the flagship path); with one, ``lin_edge`` runs first and the
projected edges go to K2.  The backward takes the edge set's source-ordered
view and its ``fused_bwd`` choice (K3 + K4, or K3 + K5).  Under model
shards the sub-graph is a ``parallel/halo.HaloShard`` and the attention is
``halo_gt_attention`` (JAX ``graph_blocks.py`` halo dispatch): the query and
key norms run before the exchange, and ``lin_edge`` is fused per shard (K1)
unless an ``edge_pre_mlp`` asks for the projected edges.  Under ``heads``
the processor block's sub-graph is a ``parallel/heads.HeadsShard`` and the
attention is ``ulysses_gt_attention`` (JAX ``graph_blocks.py:242-259``):
the norms run on the rank's rows, the attention on the whole processor set
for the rank's heads, ``lin_edge`` fused with those heads' columns (K1).
On a ``parallel/rows.BlockShard`` (a ``DynamicKNN`` mapper's runtime set of
the rank's destinations) the keys and values of the whole source set are
gathered from every rank and the attention runs on that CSR.

Switches, as in the JAX blocks: ``cond_dim`` (the JAX ``conditional``)
makes every norm of the block a ``ConditionalLayerNorm`` over the
conditioning ``cond`` (one tensor for the processor block, a ``(src, dst)``
pair for the mapper block); ``mlp_implementation`` picks the MLP's hidden
layer (``mlp`` or a gated variant); ``qk_norm_type`` the query/key norm.

The GNN blocks (anemoi's original GNN) run no kernel of their own: the edge
MLP over ``[x_i, x_j, e]`` (``x_i`` the destination's features, ``x_j`` the
source's), then the sum of the updated edges into each destination
(``ops/segment.py``).  Under model shards the GNN runs on the halo route:
on a ``HaloShard`` each block exchanges the source rows its shard's edges
read and sums its CSR's edges (``full``: the shard's destinations over
``[local | halo]`` sources) into the local destinations; the edge latents
belong to their destination's rank.  On a ``BlockShard`` (a runtime set)
the sources are gathered whole.  With the plain ``mlp`` hidden layer the edge MLP's
first Linear is split as the JAX ``_DecomposedEdgeMLP`` splits it: its
weight ``[hidden, c_dst + c_src + f]`` in that order, the node parts
``x_dst @ Wi`` and ``x_src @ Wj`` taken once a node and gathered to the
edges, plus ``e @ We + b``; its activation goes through the ``mlp_hidden``
op, as the JAX one is tagged ``mlp_hidden``.  A gated hidden layer takes the
concatenation instead, as in the JAX package.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from anemoi_tpu_torch.models.graph import SubGraphArrays
from anemoi_tpu_torch.models.layers.mlp import MLP, compute_mlp_hidden_dim, get_activation
from anemoi_tpu_torch.models.layers.normalization import LayerNorm, QKNorm, norm
from anemoi_tpu_torch.ops.gt_attention import gt_attention, gt_attention_fe
from anemoi_tpu_torch.ops.segment import gather_edge_endpoints, graph_conv_aggregate
from anemoi_tpu_torch.parallel.halo import HaloShard, _depends_on, halo_exchange_b, halo_gt_attention
from anemoi_tpu_torch.parallel.heads import HeadsShard, ulysses_gt_attention
from anemoi_tpu_torch.parallel.rows import BlockShard


class GraphTransformerBaseBlock(nn.Module):
    """The q/k/v/edge projections and the sparse attention shared by the
    mapper and processor blocks (the JAX ``GraphTransformerAttention``).

    ``plain_attention`` selects the plain PyTorch attention instead of the
    CUDA kernel; it exists so that a run on the card can be compared with the
    same model on the plain version."""

    def __init__(
        self, in_channels: int, hidden_dim: int, out_channels: int, num_heads: int,
        edge_dim: int, attn_channels: Optional[int] = None, qk_norm: bool = False,
        edge_pre_mlp: bool = False, qk_norm_type: str = "layernorm",
        mlp_implementation: str = "mlp", cond_dim: Optional[int] = None,
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
        self.q_norm = QKNorm(hd // num_heads, qk_norm_type) if qk_norm else None
        self.k_norm = QKNorm(hd // num_heads, qk_norm_type) if qk_norm else None
        self.edge_pre_mlp = (
            MLP(edge_dim, edge_dim, edge_dim, layer_norm=False) if edge_pre_mlp else None
        )
        self.node_dst_mlp = MLP(out_channels, hidden_dim, out_channels, layer_norm=False,
                                implementation=mlp_implementation)
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
        if isinstance(sub, BlockShard):
            hd = key.shape[-1]
            kv = sub.gather_src(torch.cat([key, value], dim=-1))
            out = self._attend(query, kv[..., :hd].contiguous(), kv[..., hd:].contiguous(),
                               sub.sub, e)
            return _depends_on(out, kv)
        return self._attend(query, key, value, sub, e)

    def _attend(self, query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, sub,
                e: torch.Tensor) -> torch.Tensor:
        """The sparse attention of the projected rows over ``sub`` (a
        sub-graph, or a rank's ``HeadsShard`` or ``HaloShard``)."""
        if isinstance(sub, HeadsShard):
            if self.edge_pre_mlp is None:
                return ulysses_gt_attention(query, key, value, sub, self.num_heads, edge_attr=e,
                                            weight=self.lin_edge.weight.t(),
                                            bias=self.lin_edge.bias, plain=self.plain_attention)
            return ulysses_gt_attention(query, key, value, sub, self.num_heads,
                                        edges=self.lin_edge(self.edge_pre_mlp(e)),
                                        plain=self.plain_attention)
        if isinstance(sub, HaloShard):
            if self.edge_pre_mlp is None:
                return halo_gt_attention(query, key, value, sub, self.num_heads, edge_attr=e,
                                         weight=self.lin_edge.weight.t(), bias=self.lin_edge.bias,
                                         plain=self.plain_attention)
            return halo_gt_attention(query, key, value, sub, self.num_heads,
                                     edges=self.lin_edge(self.edge_pre_mlp(e)),
                                     plain=self.plain_attention)
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
        cond_dim = kwargs.get("cond_dim")
        self.layer_norm_attention_src = norm(in_channels, cond_dim)
        self.layer_norm_attention_dest = norm(in_channels, cond_dim)
        self.layer_norm_mlp_dst = norm(out_channels, cond_dim)

    def forward(
        self, x: Tuple[torch.Tensor, torch.Tensor], sub: SubGraphArrays,
        edge_attr: torch.Tensor, cond: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        cond_src, cond_dst = (None, None) if cond is None else cond
        x_src = self.layer_norm_attention_src(x[0], cond_src)
        x_dst = self.layer_norm_attention_dest(x[1], cond_dst)
        x_r = self.lin_self(x_dst)
        out = self.attention(x_src, x_dst, sub, edge_attr)
        out = self.projection(out + x_r) + x[1]
        out = self.node_dst_mlp(self.layer_norm_mlp_dst(out, cond_dst)) + out
        return x[0], out


class GraphTransformerProcessorBlock(GraphTransformerBaseBlock):
    """Homogeneous graph-transformer block over the hidden mesh."""

    def __init__(self, in_channels: int, hidden_dim: int, out_channels: int, num_heads: int,
                 edge_dim: int, **kwargs) -> None:
        super().__init__(in_channels, hidden_dim, out_channels, num_heads, edge_dim, **kwargs)
        cond_dim = kwargs.get("cond_dim")
        self.layer_norm_attention = norm(in_channels, cond_dim)
        self.layer_norm_mlp_dst = norm(out_channels, cond_dim)

    def forward(self, x: torch.Tensor, sub: SubGraphArrays, edge_attr: torch.Tensor,
                cond: Optional[torch.Tensor] = None) -> torch.Tensor:
        x_n = self.layer_norm_attention(x, cond)
        x_r = self.lin_self(x_n)
        out = self.attention(x_n, x_n, sub, edge_attr)
        out = self.projection(out + x_r) + x
        return self.node_dst_mlp(self.layer_norm_mlp_dst(out, cond)) + out


def gnn_mlp(in_features: int, hidden_dim: int, out_features: int, mlp_extra_layers: int,
             implementation: str, layer_norm: bool = True) -> MLP:
    """The GNN's MLP: ``mlp_extra_layers + 1`` extra hidden layers, as every
    MLP of the JAX GNN blocks and mappers runs."""
    return MLP(in_features, hidden_dim, out_features, layer_norm=layer_norm,
               implementation=implementation, n_extra_layers=mlp_extra_layers + 1)


def source_rows(x_src: torch.Tensor, sub):
    """``(sources, csr)`` of a GNN block: on a ``HaloShard`` the rank's
    padded rows and the rows its peers send (``[local | halo]``) with the
    shard's CSR; on a ``BlockShard`` the whole source set with the rank's
    runtime CSR; else ``x_src`` and ``sub``."""
    if isinstance(sub, HaloShard):
        return halo_exchange_b(x_src, sub), sub.full
    if isinstance(sub, BlockShard):
        return sub.gather_src(x_src), sub.sub
    return x_src, sub


class GraphConv(nn.Module):
    """GNN message function and aggregation: ``e_new = edge_mlp([x_i, x_j,
    e]) + e`` and ``out[d] = sum of e_new over the edges into d``; returns
    ``(out, e_new)``.  ``e`` is ``[B, E, C]`` (embedded, or the previous
    layer's)."""

    def __init__(self, in_channels_src: int, in_channels_dst: int, edge_dim: int,
                 out_channels: int, mlp_extra_layers: int = 0,
                 mlp_implementation: str = "mlp") -> None:
        super().__init__()
        self.split = (in_channels_dst, in_channels_src, edge_dim)
        self.decomposed = mlp_implementation == "mlp"
        self.edge_mlp = gnn_mlp(sum(self.split), out_channels, out_channels, mlp_extra_layers,
                                 mlp_implementation)

    def _edge_mlp_decomposed(self, x_src, x_dst, edge_attr, sub):
        first, hidden, *tail = self.edge_mlp.mlp
        w_i, w_j, w_e = first.weight.split(self.split, dim=1)
        p_i, p_j = gather_edge_endpoints(x_src @ w_j.t(), x_dst @ w_i.t(), sub.edge_index)
        h = hidden(p_i + p_j + edge_attr @ w_e.t() + first.bias)
        for layer in tail:
            h = layer(h)
        return self.edge_mlp.finish(h)

    def forward(self, x_src: torch.Tensor, x_dst: torch.Tensor, edge_attr: torch.Tensor,
                sub: SubGraphArrays) -> Tuple[torch.Tensor, torch.Tensor]:
        x_ext, sub = source_rows(x_src, sub)
        if self.decomposed:
            edges_new = self._edge_mlp_decomposed(x_ext, x_dst, edge_attr, sub) + edge_attr
        else:
            x_i, x_j = gather_edge_endpoints(x_ext, x_dst, sub.edge_index)
            edges_new = self.edge_mlp(torch.cat([x_i, x_j, edge_attr], dim=-1)) + edge_attr
        out = graph_conv_aggregate(edges_new, sub.edge_index[1], sub.num_dst)
        return (out if x_ext is x_src else _depends_on(out, x_ext)), edges_new


class GraphConvProcessorBlock(nn.Module):
    """GNN processor block: ``conv``, then ``node_mlp([x, out]) + x``.  With
    ``edge_dim`` (the first layer) it first embeds the raw edge attributes
    ``[E, F]`` with ``emb_edges`` and broadcasts them over the batch."""

    def __init__(self, num_channels: int, mlp_extra_layers: int = 0,
                 mlp_hidden_ratio: float = 1.0, edge_dim: Optional[int] = None,
                 mlp_implementation: str = "mlp") -> None:
        super().__init__()
        c = num_channels
        hidden = compute_mlp_hidden_dim(c, mlp_hidden_ratio)
        self.emb_edges = (None if edge_dim is None else
                          gnn_mlp(edge_dim, hidden, c, mlp_extra_layers, mlp_implementation))
        self.conv = GraphConv(c, c, c, c, mlp_extra_layers, mlp_implementation)
        self.node_mlp = gnn_mlp(2 * c, hidden, c, mlp_extra_layers, mlp_implementation)

    def forward(self, x: torch.Tensor, edge_attr: torch.Tensor,
                sub: SubGraphArrays) -> Tuple[torch.Tensor, torch.Tensor]:
        if self.emb_edges is not None:
            # the raw attributes in the compute type, as the GNN mappers cast
            # them (the JAX block's Dense promotes to their float32 instead)
            edge_attr = self.emb_edges(edge_attr.to(x.dtype))
            if edge_attr.dim() == 2:  # static edges, shared by the batch
                edge_attr = edge_attr.expand((x.shape[0],) + edge_attr.shape)
        out, edges_new = self.conv(x, x, edge_attr, sub)
        return self.node_mlp(torch.cat([x, out], dim=-1)) + x, edges_new


class GraphConvMapperBlock(nn.Module):
    """GNN mapper block: ``conv`` from the source to the destination nodes,
    then ``node_mlp([x_dst, out]) + x_dst``; with ``update_src_nodes`` the
    same ``node_mlp`` also updates the sources, on ``[x_src, x_src]``."""

    def __init__(self, num_channels: int, mlp_extra_layers: int = 0,
                 mlp_hidden_ratio: float = 1.0, update_src_nodes: bool = True,
                 mlp_implementation: str = "mlp") -> None:
        super().__init__()
        c = num_channels
        self.update_src_nodes = update_src_nodes
        self.conv = GraphConv(c, c, c, c, mlp_extra_layers, mlp_implementation)
        self.node_mlp = gnn_mlp(2 * c, compute_mlp_hidden_dim(c, mlp_hidden_ratio), c,
                                 mlp_extra_layers, mlp_implementation)

    def forward(self, x: Tuple[torch.Tensor, torch.Tensor], edge_attr: torch.Tensor,
                sub: SubGraphArrays):
        x_src, x_dst = x
        out, edges_new = self.conv(x_src, x_dst, edge_attr, sub)
        x_dst = self.node_mlp(torch.cat([x_dst, out], dim=-1)) + x_dst
        if self.update_src_nodes:
            x_src = self.node_mlp(torch.cat([x_src, x_src], dim=-1)) + x_src
        return (x_src, x_dst), edges_new


class PointWiseMLPBlock(nn.Module):
    """Point-wise block, no message passing and no residual:
    ``linear_out(act(norm(linear_in(x))))``, with ``linear_out`` only where
    the hidden width differs from ``num_channels``."""

    def __init__(self, num_channels: int, hidden_dim: int, activation: str = "gelu") -> None:
        super().__init__()
        self.activation = get_activation(activation)
        self.linear_in = nn.Linear(num_channels, hidden_dim)
        self.norm = LayerNorm(hidden_dim)
        self.linear_out = (nn.Linear(hidden_dim, num_channels) if hidden_dim != num_channels
                           else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.activation(self.norm(self.linear_in(x)))
        return h if self.linear_out is None else self.linear_out(h)
