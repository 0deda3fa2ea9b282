"""Ulysses ("heads") sequence parallelism over a ``torch.distributed`` model group.

Port of ``anemoi_tpu.parallel.heads`` (DeepSpeed-Ulysses, Jacobs et al.
2023; anemoi-core's ``heads`` shard strategy).  Each rank of a model group
of ``S`` holds a contiguous block of the processor's rows, ``[B, n_local,
H, D]`` (the hidden mesh's block of ``parallel/partition.py``: ``n_local =
round_up(ceil(N / S), 8)`` rows, the last blocks padded at their tail).
One ``all_to_all`` (:func:`seq_to_heads`) gives every rank the whole
sequence for its ``H / S`` heads, ``[B, S * n_local, H / S, D]``: the
blocks in rank order, so the ``N`` real rows come first and the pad after
them.  The rank attends over those rows with the attention one rank runs
(K6/K7 for the band, K1 with K3 + K4 for the graph attention on the
processor set's global CSR), and the reverse ``all_to_all``
(:func:`heads_to_seq`) returns its rows with every head.  Each exchange is
an autograd Function whose backward is the other one.

Pad rows never reach the attention: the sequence is cut to its ``N`` real
rows before it and the output padded back with zeros after it, as the JAX
graph path does (``heads.py:140-150``); the JAX dense path masks the pad
keys instead (``valid_len``), which gives the real rows the same values.
The dense attention's choice between full attention and the band follows
the JAX ``_window_attention`` on the JAX package's padded length
``ceil(N / S) * S`` (not ``S * n_local``): full when ``2 w + 1`` reaches
it.  Each rank takes its heads' ALiBi slopes and, for the graph attention,
its heads' columns of the edge projection's weight and bias (their
gradients land in those columns; the training step sums every parameter's
gradient over the model group).  Rotary embeddings rotate by the position
in the whole sequence.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from anemoi_tpu_torch.parallel.distributed import all_to_all
from anemoi_tpu_torch.parallel.mesh import block_rows, grid_block


def _exchange(blocks: torch.Tensor, group) -> torch.Tensor:
    """``[S, ...]`` -> ``[S, ...]``: block ``j`` to rank ``j`` of ``group``,
    block ``j`` of the result from rank ``j``."""
    return all_to_all(blocks, group).wait()


def _to_heads(x: torch.Tensor, group, size: int) -> torch.Tensor:
    b, n, h, d = x.shape
    blocks = x.reshape(b, n, size, h // size, d).permute(2, 0, 1, 3, 4)  # [S, B, n, h/S, d]
    recv = _exchange(blocks, group)
    return recv.permute(1, 0, 2, 3, 4).reshape(b, size * n, h // size, d)


def _to_seq(x: torch.Tensor, group, size: int) -> torch.Tensor:
    b, n_all, h, d = x.shape
    n = n_all // size
    blocks = x.reshape(b, size, n, h, d).permute(1, 0, 2, 3, 4)  # [S, B, n, h, d]
    recv = _exchange(blocks, group)
    return recv.permute(1, 2, 0, 3, 4).reshape(b, n, size * h, d)


class _SeqToHeads(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _to_heads(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return _to_seq(g, ctx.group, ctx.size), None, None


class _HeadsToSeq(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, size):
        ctx.group, ctx.size = group, size
        return _to_seq(x, group, size)

    @staticmethod
    def backward(ctx, g):
        return _to_heads(g, ctx.group, ctx.size), None, None


def group_size(group) -> int:
    import torch.distributed as dist

    return 1 if group is None else dist.get_world_size(group)


def seq_to_heads(x: torch.Tensor, group) -> torch.Tensor:
    """``[B, n_local, H, D]`` sequence-sharded -> ``[B, S * n_local, H / S,
    D]`` head-sharded.  Collective over ``group``."""
    size = group_size(group)
    if x.shape[2] % size:
        raise ValueError(f"num_heads {x.shape[2]} not divisible by the model group's {size} "
                         "ranks (shard_strategy heads)")
    return _SeqToHeads.apply(x, group, size)


def heads_to_seq(x: torch.Tensor, group) -> torch.Tensor:
    """``[B, S * n_local, H / S, D]`` head-sharded -> ``[B, n_local, H, D]``
    sequence-sharded.  Collective over ``group``."""
    return _HeadsToSeq.apply(x, group, group_size(group))


@dataclass
class HeadsShard:
    """One rank's share of the processor under ``heads``: its block of the
    ``num_nodes`` hidden rows (``n_local`` rows, padded), the model group,
    and the processor's edge set whole (None for a processor without edges),
    which every rank attends over for its heads."""

    group: object
    num_shards: int
    index: int
    num_nodes: int
    sub: Optional[object] = None  # the processor's SubGraphArrays

    @property
    def n_local(self) -> int:
        return block_rows(self.num_nodes, self.num_shards)

    @property
    def dst_rows(self) -> slice:
        """This rank's real rows of the hidden mesh."""
        return grid_block(self.num_nodes, self.num_shards, self.index)

    src_rows = dst_rows

    @property
    def padded_len(self) -> int:
        """The JAX package's padded sequence, ``ceil(N / S) * S``: the length
        its dense attention picks full or band by."""
        return -(-self.num_nodes // self.num_shards) * self.num_shards

    def head_block(self, num_heads: int) -> slice:
        """This rank's heads."""
        if num_heads % self.num_shards:
            raise ValueError(f"num_heads {num_heads} not divisible by the model group's "
                             f"{self.num_shards} ranks (shard_strategy heads)")
        h = num_heads // self.num_shards
        return slice(self.index * h, (self.index + 1) * h)


def _real_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    return x[:, :n].contiguous()


def _pad_back(out: torch.Tensor, n_all: int) -> torch.Tensor:
    pad = n_all - out.shape[1]
    if pad <= 0:
        return out
    return torch.cat([out, out.new_zeros((out.shape[0], pad) + out.shape[2:])], dim=1)


def ulysses_mhsa(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, shard: HeadsShard,
    window_size: Optional[int], softcap: Optional[float] = None,
    alibi_slopes: Optional[torch.Tensor] = None, rotary: bool = False, plain: bool = False,
) -> torch.Tensor:
    """The dense self-attention of this rank's rows ``[B, n_local, H, D]``
    (q/k normed, not yet rotated) under ``heads``: the whole sequence for
    its heads, full or band by the JAX rule on the padded length, on the
    ``N`` real rows; returns ``[B, n_local, H, D]``."""
    from anemoi_tpu_torch.models.layers.attention import (
        apply_rotary_embeddings,
        full_attention_plain,
    )
    from anemoi_tpu_torch.ops.window_attention import band_attention

    heads = shard.head_block(q.shape[2])
    qh, kh, vh = (seq_to_heads(t, shard.group) for t in (q, k, v))
    n_all, n = qh.shape[1], shard.num_nodes
    qh, kh, vh = (_real_rows(t, n) for t in (qh, kh, vh))
    if rotary:
        qh, kh = apply_rotary_embeddings(qh, kh)
    slopes = None if alibi_slopes is None else alibi_slopes[heads]
    softcap = float(softcap) if softcap else None
    if window_size is None or 2 * int(window_size) + 1 >= shard.padded_len:
        out = full_attention_plain(qh, kh, vh, softcap, slopes)
    else:
        out = band_attention(qh, kh, vh, window_size, softcap, slopes, plain)
    return heads_to_seq(_pad_back(out, n_all), shard.group)


def ulysses_gt_attention(
    query: torch.Tensor, key: torch.Tensor, value: torch.Tensor, shard: HeadsShard,
    num_heads: int, *, edges: Optional[torch.Tensor] = None,
    edge_attr: Optional[torch.Tensor] = None, weight: Optional[torch.Tensor] = None,
    bias: Optional[torch.Tensor] = None, plain: bool = False,
) -> torch.Tensor:
    """The graph attention of this rank's rows ``[B, n_local, HD]`` under
    ``heads``: for its ``H / S`` heads over the processor set's global CSR,
    with the edge projection fused (``edge_attr [E, F]``, its heads'
    columns of ``weight [F, HD]`` and ``bias``: K1, K3 + K4 on the card)
    or pre-projected ``edges [E, HD]`` (its heads' columns)."""
    from anemoi_tpu_torch.ops.gt_attention import gt_attention, gt_attention_fe

    b, n_loc, hd = query.shape
    d = hd // num_heads
    heads = shard.head_block(num_heads)
    cols = slice(heads.start * d, heads.stop * d)
    h = heads.stop - heads.start

    def to_heads(x):
        return seq_to_heads(x.reshape(b, n_loc, num_heads, d), shard.group)

    qh, kh, vh = (to_heads(t) for t in (query, key, value))
    n_all, n = qh.shape[1], shard.num_nodes
    qh, kh, vh = (_real_rows(t, n).reshape(b, n, h * d) for t in (qh, kh, vh))
    sub = shard.sub
    if edges is not None:
        out, _ = gt_attention(qh, kh, vh, edges[:, cols].contiguous(), sub.edge_index, sub.dst_ptr, h,
                              plain=plain, source=sub.source, fused_bwd=sub.fused_bwd)
    else:
        out, _ = gt_attention_fe(qh, kh, vh, edge_attr, weight[:, cols].contiguous(),
                                 bias[cols].contiguous(),
                                 sub.edge_index, sub.dst_ptr, h, plain=plain,
                                 source=sub.source, fused_bwd=sub.fused_bwd)
    out = _pad_back(out.reshape(b, n, h, d), n_all)
    return heads_to_seq(out, shard.group).reshape(b, n_loc, hd)
