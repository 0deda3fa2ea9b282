"""Row-block routes over a model group that need no halo tables.

Every node set of a model split over a model group of ``S`` ranks is cut in
the contiguous blocks of ``parallel/partition.py``: rank ``i`` owns rows
``grid_block(N, S, i)``, ``round_up(ceil(N / S), 8)`` rows a block, the last
blocks short or empty.  The halo tables (``parallel/halo.py``) exchange only
the rows a sparse edge set reads; what reads every row of a node set takes
it whole:

- :func:`gather_blocks`: the whole node set on every rank, each rank's
  block joined in rank order and the pad rows dropped.  Its backward sums
  every rank's cotangent (an all-reduce) and keeps the rank's own block:
  each rank's loss is its share of the whole loss, so the cotangents of
  one row on the ranks add up to that row's gradient.
- :func:`all_reduce_sum`: a sum over the group whose backward sums the
  cotangents the same way.
- :class:`BlockShard`: a rank's blocks of a destination and a source set
  with no exchange tables: the point-wise components (every row local: a
  point-wise model's data and hidden sets have one size, so they split in
  the same blocks), the dense cross-attention mappers (the destinations'
  queries over the whole source set) and a ``DynamicKNN`` mapper (the
  runtime set of the rank's destinations over the whole source set, in
  ``sub``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import torch

from anemoi_tpu_torch.parallel.distributed import all_gather, all_reduce
from anemoi_tpu_torch.parallel.mesh import block_rows, grid_block


def _pad_to(x: torch.Tensor, dim: int, rows: int) -> torch.Tensor:
    pad = rows - x.shape[dim]
    if pad <= 0:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim=dim)


def all_gather_blocks(x: torch.Tensor, dim: int, group, num_rows: int, num_shards: int
                      ) -> torch.Tensor:
    """Each rank's block of ``x`` (its real rows along ``dim``) joined in
    rank order into the ``num_rows`` rows of the whole set; no gradient."""
    if group is None:
        return x
    parts = all_gather(_pad_to(x, dim, block_rows(num_rows, num_shards)), group)
    return torch.cat(parts, dim=dim).narrow(dim, 0, num_rows)


class _GatherBlocks(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group, num_rows, num_shards, index):
        ctx.dim, ctx.group, ctx.rows, ctx.index = dim, group, x.shape[dim], index
        ctx.block = block_rows(num_rows, num_shards)
        ctx.total = ctx.block * num_shards
        return all_gather_blocks(x, dim, group, num_rows, num_shards)

    @staticmethod
    def backward(ctx, g):
        g = _pad_to(g, ctx.dim, ctx.total).contiguous().clone()
        all_reduce(g, ctx.group)
        return g.narrow(ctx.dim, ctx.index * ctx.block, ctx.rows), None, None, None, None, None


def gather_blocks(x: torch.Tensor, dim: int, group, num_rows: int, num_shards: int,
                  index: int) -> torch.Tensor:
    """The whole node set from each rank's real rows of it along ``dim``;
    the backward sums every rank's cotangent and keeps this rank's rows.
    Collective over ``group`` (identity without one)."""
    if group is None:
        return x
    return _GatherBlocks.apply(x, dim, group, num_rows, num_shards, index)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous().clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """``t`` summed over ``group``, with the cotangents summed over it in
    the backward.  Collective."""
    if group is None:
        return t
    return _AllReduceSum.apply(t, group)


@dataclass
class BlockShard:
    """One rank's blocks of a destination set (``num_dst`` rows) and a
    source set (``num_src``) split over the model ``group``, with the
    rank's destination CSR over the whole source set in ``sub`` where a
    component needs one (a ``DynamicKNN`` mapper's runtime set)."""

    group: object
    num_shards: int
    index: int
    num_dst: int
    num_src: int
    sub: Optional[object] = None

    @property
    def n_local(self) -> int:
        return block_rows(self.num_dst, self.num_shards)

    @property
    def n_local_src(self) -> int:
        return block_rows(self.num_src, self.num_shards)

    @property
    def dst_rows(self) -> slice:
        return grid_block(self.num_dst, self.num_shards, self.index)

    @property
    def src_rows(self) -> slice:
        return grid_block(self.num_src, self.num_shards, self.index)

    def gather_src(self, x: torch.Tensor, dim: int = 1) -> torch.Tensor:
        """The whole source set from this rank's rows (:func:`gather_blocks`)."""
        return gather_blocks(x, dim, self.group, self.num_src, self.num_shards, self.index)

    def with_sub(self, sub) -> "BlockShard":
        return dataclasses.replace(self, sub=sub)
