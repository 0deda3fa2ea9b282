"""Sparse ops of the GNN: the endpoint gather and the sum into destinations.

Port of ``anemoi_tpu.ops.segment.graph_conv_aggregate`` and of the graph
blocks' ``_gather_edge_endpoints``.  The JAX package computes them with
``jax.ops.segment_sum`` / ``jnp.take`` (or its padded XLA gathers); no Pallas
kernel is involved, so these are PyTorch ops on both the CPU and the card.

Both accumulate in float32 and cast back: the sum into destinations is an
``index_add_`` over ``dst`` into a float32 buffer, and the gather's backward
(a sum over each node's edges) is the same float32 ``index_add_``.  On the
card ``index_add_`` adds with atomics, and a bf16 one would round at every
add; a node of the ``multi_scale`` mesh sums 6-12 edges, the data nodes of
the decoder 3, the hidden nodes of the encoder up to ~30.  ``index_add_`` was
chosen over a segment sum over the dst-sorted CSR (``dst_ptr``) because it is
one library call forward and backward; the atomics make the sum's order, and
so its last bits, vary from run to run on the card (a deterministic CSR
segment sum is a candidate for a later kernel, ROADMAP "Not port work").
"""

from __future__ import annotations

from typing import Tuple

import torch


def _sum_rows(values: torch.Tensor, index: torch.Tensor, num_rows: int) -> torch.Tensor:
    """``out[:, index[e]] += values[:, e]`` for ``values [B, E, C]``, summed in
    float32, returned in ``values``' type."""
    out = values.new_zeros((values.shape[0], num_rows, values.shape[2]), dtype=torch.float32)
    return out.index_add_(1, index, values.float()).to(values.dtype)


class _GatherRows(torch.autograd.Function):
    """``x[:, index]`` whose backward sums the gradient rows in float32."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(index)
        ctx.num_rows = x.shape[1]
        return x.index_select(1, index)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (index,) = ctx.saved_tensors
        return _sum_rows(grad, index, ctx.num_rows), None


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """Rows ``x[:, index]`` of ``x [B, N, C]``: ``[B, len(index), C]``."""
    return _GatherRows.apply(x, index)


def gather_edge_endpoints(
    x_src: torch.Tensor, x_dst: torch.Tensor, edge_index: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-edge endpoint features ``(x_i, x_j)``, each ``[B, E, C]``: ``x_i``
    gathered from ``x_dst`` by destination, ``x_j`` from ``x_src`` by source."""
    src, dst = edge_index[0].long(), edge_index[1].long()
    return gather_rows(x_dst, dst), gather_rows(x_src, src)


def graph_conv_aggregate(edges: torch.Tensor, dst: torch.Tensor, num_dst: int) -> torch.Tensor:
    """Sum the edge messages ``[B, E, C]`` into their destinations:
    ``[B, num_dst, C]`` (zero for a node without edges)."""
    return _sum_rows(edges, dst.long(), num_dst)
