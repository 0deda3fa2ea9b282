"""The random draws of the transport family.

Port of ``anemoi_tpu.models.transport.random_fields``, and the one place
where the transport code draws: :func:`standard_normal` and :func:`uniform`
(float32 on the generator's device), so that a test can hand both packages
the same arrays.

Under data and model parallelism every rank draws from the same generator
the field one process draws for the global batch over the whole grid, and
keeps its block (:func:`randn_grid_sharded`, the JAX shard_map answer: draw
the full field and slice the shard's rows; :class:`DrawShard` and
:func:`sharded_normal` for the batch rows and ensemble members too), so
each sample, member and grid point gets its one-process draw whatever the
mesh.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch


def standard_normal(shape: Sequence[int], generator: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=dtype)


def uniform(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Uniform in ``[0, 1)``, float32."""
    return torch.rand(tuple(shape), generator=generator, device=generator.device)


def randn_grid_sharded(generator: torch.Generator, shape: Sequence[int],
                       dtype: torch.dtype = torch.float32, *,
                       shard_sizes: Optional[Sequence[int]] = None,
                       shard_index: Optional[int] = None, shard_dim: int = -2) -> torch.Tensor:
    """A Gaussian field over the whole grid, and this shard's rows of it.

    Without ``shard_sizes``: the plain draw of ``shape``.  With the sizes of
    every shard's block along ``shard_dim`` (in order; the port's row blocks
    may end short, so they need not be equal as the JAX ones must) and
    ``shard_index``: the field of the whole axis (their sum) is drawn and
    block ``shard_index`` returned, the same rows one process draws."""
    if shard_sizes is None:
        return standard_normal(shape, generator, dtype)
    if shard_index is None:
        raise ValueError("randn_grid_sharded: shard_sizes needs shard_index")
    ndim = len(shape)
    if not -ndim <= shard_dim < ndim:
        raise ValueError(f"Cannot shard random tensor of rank {ndim} along dim {shard_dim}.")
    shard_dim %= ndim
    sizes = [int(s) for s in shard_sizes]
    if int(shape[shard_dim]) != sizes[shard_index]:
        raise ValueError(f"shape {tuple(shape)} has {shape[shard_dim]} rows along dim "
                         f"{shard_dim}, shard {shard_index} of {sizes} has {sizes[shard_index]}")
    full = list(shape)
    full[shard_dim] = sum(sizes)
    noise = standard_normal(full, generator, dtype)
    return noise.narrow(shard_dim, sum(sizes[:shard_index]), sizes[shard_index])


@dataclass(frozen=True)
class DrawShard:
    """Where a rank's ``[B, T, E, G, V]`` block lies in the one-process
    field: batch block ``batch_index`` of ``batch_shards`` equal blocks,
    member block ``member_index`` of ``member_shards`` equal blocks (the
    ensemble group's), and grid block ``grid_index`` of blocks
    ``grid_sizes`` (None: the whole grid)."""

    batch_index: int = 0
    batch_shards: int = 1
    grid_sizes: Optional[Tuple[int, ...]] = None
    grid_index: int = 0
    member_index: int = 0
    member_shards: int = 1

    def global_shape(self, shape: Sequence[int]) -> Tuple[int, ...]:
        """``shape`` with the global batch and every member."""
        full = [int(s) for s in shape]
        full[0] *= self.batch_shards
        full[2] *= self.member_shards
        return tuple(full)

    def block(self, t: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
        """This rank's batch rows and members (``shape[0]`` and ``shape[2]``
        of them) of a draw over the global batch and every member."""
        b, m = int(shape[0]), int(shape[2])
        return t.narrow(0, self.batch_index * b, b).narrow(2, self.member_index * m, m)


def sharded_normal(generator: torch.Generator, shape: Sequence[int],
                   dtype: torch.dtype = torch.float32,
                   shard: Optional[DrawShard] = None) -> torch.Tensor:
    """A standard normal ``[B, T, E, G, V]`` field (``shape``: the rank's
    block) as one process draws it for the global batch, every member and
    the whole grid, cut to ``shard``'s block; the plain draw without a
    shard."""
    if shard is None:
        return standard_normal(shape, generator, dtype)
    full = shard.global_shape(shape)
    if shard.grid_sizes is not None:
        noise = randn_grid_sharded(generator, full, dtype, shard_sizes=shard.grid_sizes,
                                   shard_index=shard.grid_index, shard_dim=3)
    else:
        noise = standard_normal(full, generator, dtype)
    return shard.block(noise, shape)
