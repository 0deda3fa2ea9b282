"""The random draws of the transport family.

Port of ``anemoi_tpu.models.transport.random_fields`` on one device, and
the one place where the transport code draws: :func:`standard_normal` and
:func:`uniform` (float32 on the generator's device), so that a test can
hand both packages the same arrays.  The draw of a field sharded over the
grid (``shard_sizes``) belongs to model parallelism, which is not ported.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def standard_normal(shape: Sequence[int], generator: torch.Generator,
                    dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return torch.randn(tuple(shape), generator=generator, device=generator.device, dtype=dtype)


def uniform(shape: Sequence[int], generator: torch.Generator) -> torch.Tensor:
    """Uniform in ``[0, 1)``, float32."""
    return torch.rand(tuple(shape), generator=generator, device=generator.device)


def randn_grid_sharded(generator: torch.Generator, shape: Sequence[int],
                       dtype: torch.dtype = torch.float32, *,
                       shard_sizes: Optional[Sequence[int]] = None) -> torch.Tensor:
    """A Gaussian field over the whole grid."""
    if shard_sizes is not None:
        raise NotImplementedError("random fields sharded over the grid belong to model "
                                  "parallelism, which is not ported (ROADMAP.md Queue 1, item 9)")
    return standard_normal(shape, generator, dtype)
