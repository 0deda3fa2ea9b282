"""Processor chain: ordered pre/post-processing.

Port of ``anemoi_tpu.preprocessing.processors.Processors``: each processor's
transform in order (forward), the inverse transforms in reverse order.  Only
``InputNormalizer`` is ported; every other processor name raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.preprocessing.normalizer import InputNormalizer

PROCESSORS = {"InputNormalizer": InputNormalizer}


class Processors:
    def __init__(self, processors: List) -> None:
        self.processors = list(processors)

    def transform(self, x: torch.Tensor) -> torch.Tensor:
        for p in self.processors:
            x = p.transform(x)
        return x

    def inverse_transform(self, x: torch.Tensor) -> torch.Tensor:
        for p in reversed(self.processors):
            x = p.inverse_transform(x)
        return x


def build_processors(
    configs: Optional[List[dict]],
    data_indices: IndexCollection,
    statistics: Dict[str, np.ndarray],
    device: torch.device | str = "cpu",
) -> Processors:
    """Build the ordered chain from entries like
    ``[{"name": "InputNormalizer", "default": "mean-std"}]``."""
    processors = []
    for cfg in configs or []:
        cfg = dict(cfg)
        name = cfg.pop("name")
        if name not in PROCESSORS:
            raise NotImplementedError(f"preprocessor '{name}' is not ported to anemoi_tpu_torch")
        processors.append(PROCESSORS[name](data_indices, statistics, device=device, **cfg))
    return Processors(processors)
