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
``cond`` (``[B·M, N, cond_dim]``, the ensemble's noise conditioning, or
``[B·E, 1, cond_dim]``, a transport model's noise level broadcast over the
nodes) goes to every block, an input of each block's checkpoint as its
parameters are.

Under model shards the GraphTransformer processor takes a
``parallel/halo.HaloShard`` (JAX ``processor.py`` halo branch): the rank's
rows are padded to its block once, per-node conditioning with them, the
edge features permuted into its layout once, and the padded rows dropped
after the last block.  Under ``heads`` the GraphTransformer processor takes
a ``parallel/heads.HeadsShard`` as its sub-graph and the Transformer
processor takes one as ``shard`` (JAX ``processor.py:109-137, 352-380``):
the rows and per-node conditioning are padded the same way, the edge
features stay whole, and every block's attention runs on the rank's heads
over the whole sequence.  Under ``edges`` the Transformer processor takes a
``parallel/band.BandShard`` as ``shard`` (the band halo: each block's
attention over the rank's extended block), and the GNN processor a
``HaloShard``: its rows are padded, the raw edge features permuted into the
shard's layout once (the edge latents it threads through its layers stay
with their destination's rank), and each block exchanges its source rows.
The point-wise processor is row-local and takes no shard.
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
from anemoi_tpu_torch.parallel.halo import HaloShard, pad_rows, permute_rows
from anemoi_tpu_torch.parallel.heads import HeadsShard


def _pad_rank_rows(x: torch.Tensor, cond: Optional[torch.Tensor], n_local: int):
    """A rank's rows padded to its block, and per-node conditioning with
    them (JAX ``processor.py:109-137``: the conditioning follows the node
    padding)."""
    n = x.shape[1]
    if cond is not None and cond.dim() == 3 and cond.shape[1] == n:
        cond = pad_rows(cond, n_local)
    return pad_rows(x, n_local), cond


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
        n = x.shape[1]
        if isinstance(sub, (HaloShard, HeadsShard)):
            x, cond = _pad_rank_rows(x, cond, sub.n_local)
        if isinstance(sub, HaloShard):
            edge_attr = permute_rows(edge_attr, sub.edge_perm, sub.edge_perm_inv)
        for block in self.proc:
            x = self._run(block, x, sub, edge_attr, cond)
        return x[:, :n]


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

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None,
                shard=None) -> torch.Tensor:
        x = x + self.attention(self.layer_norm_attention(x, cond), shard)
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

    def forward(self, x: torch.Tensor, cond: Optional[torch.Tensor] = None,
                shard=None) -> torch.Tensor:
        """``shard``: the rank's ``HeadsShard`` under ``heads``, its
        ``BandShard`` under ``edges`` (its rows padded to the block here,
        and cut back after the last block)."""
        n = x.shape[1]
        if shard is not None:
            x, cond = _pad_rank_rows(x, cond, shard.n_local)
        for block in self.proc:
            x = self._run(block, x, cond, shard)
        return x[:, :n]


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
        n = x.shape[1]
        if isinstance(sub, HaloShard):
            x = pad_rows(x, sub.n_local)
            edge_attr = permute_rows(edge_attr, sub.edge_perm, sub.edge_perm_inv).narrow(
                0, 0, sub.full.num_edges)
        for block in self.proc:
            x, edge_attr = self._run(block, x, edge_attr, sub)
        return x[:, :n]


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
