"""Node attributes: static sin/cos coordinates plus trainable embeddings.

Port of ``anemoi_tpu.models.layers.embed``.  The container is laid out as
anemoi-core's ``NamedNodesAttributes`` (``trainable_tensors.<nodes>.trainable``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn


def sincos_coordinates(coords: np.ndarray) -> np.ndarray:
    """[N, 2] (lat, lon) radians -> [N, 4] (sin lat, sin lon, cos lat, cos lon)."""
    return np.concatenate([np.sin(coords), np.cos(coords)], axis=-1).astype(np.float32)


class TrainableNodeAttributes(nn.Module):
    """Static node features with a zero-initialised trainable embedding
    ``trainable [num_nodes, trainable_size]`` appended (none when the size is 0)."""

    def __init__(self, num_nodes: int, trainable_size: int) -> None:
        super().__init__()
        self.trainable = (
            nn.Parameter(torch.zeros(num_nodes, trainable_size)) if trainable_size > 0 else None
        )

    def forward(self, static_attrs: torch.Tensor) -> torch.Tensor:
        if self.trainable is None:
            return static_attrs
        return torch.cat([static_attrs, self.trainable.to(static_attrs.dtype)], dim=-1)


class NamedNodesAttributes(nn.Module):
    """One :class:`TrainableNodeAttributes` per node set."""

    def __init__(self, num_nodes: Dict[str, int], trainable_sizes: Dict[str, int]) -> None:
        super().__init__()
        self.trainable_tensors = nn.ModuleDict(
            {name: TrainableNodeAttributes(n, int(trainable_sizes.get(name, 0)))
             for name, n in num_nodes.items()}
        )

    def forward(self, name: str, static_attrs: torch.Tensor) -> torch.Tensor:
        return self.trainable_tensors[name](static_attrs)
