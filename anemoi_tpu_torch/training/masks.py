"""Output masks for limited-area and stretched-grid training.

Port of ``anemoi_tpu.training.masks``: a LAM model is scored only inside the
area of interest (the mask's ``loss_scaler``), and during the rollout the
prognostics outside it are re-forced from the truth (``advance_input``'s
``boundary_mask``).  The mask is a graph node attribute; it is read once
and held on the device (``as_tensor``), not moved there every step.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from anemoi_tpu_torch.graphs.graph import Graph


class Boolean1DMask:
    """Grid-dim boolean mask from a graph node attribute (True inside the
    area)."""

    def __init__(self, mask: np.ndarray):
        self.mask = np.asarray(mask).reshape(-1).astype(bool)
        self._tensors: Dict[torch.device, torch.Tensor] = {}

    @classmethod
    def from_graph(cls, graph: Graph, nodes_name: str, attribute_name: str) -> "Boolean1DMask":
        return cls(graph[nodes_name].attributes[attribute_name])

    def as_tensor(self, device: torch.device | str = "cpu") -> torch.Tensor:
        """The ``[G]`` mask on ``device``, copied there once."""
        device = torch.device(device)
        if device not in self._tensors:
            self._tensors[device] = torch.as_tensor(self.mask, device=device)
        return self._tensors[device]

    def apply(self, x: torch.Tensor, fill_value: float = 0.0) -> torch.Tensor:
        """Fill the region outside the area; grid is axis -2 of ``[..., G, V]``."""
        return torch.where(self.as_tensor(x.device)[:, None], x,
                           torch.as_tensor(fill_value, dtype=x.dtype, device=x.device))

    def rollout_boundary(self, pred: torch.Tensor, truth: torch.Tensor) -> torch.Tensor:
        """Inside the area the prediction, outside it the truth."""
        return torch.where(self.as_tensor(pred.device)[:, None], pred, truth)

    def loss_scaler(self) -> np.ndarray:
        """Grid-dim loss weights: 1 inside, 0 outside."""
        return self.mask.astype(np.float32)


class NoOutputMask:
    def as_tensor(self, device=None):
        return None

    def apply(self, x, fill_value: float = 0.0):
        return x

    def rollout_boundary(self, pred, truth):
        return pred

    def loss_scaler(self):
        return None


def build_output_masks(config: Optional[Dict[str, dict]], graph: Graph) -> Dict[str, Boolean1DMask]:
    """``{dataset: {"nodes_name": ..., "attribute_name": ...}}`` -> masks."""
    return {
        ds: Boolean1DMask.from_graph(graph, cfg.get("nodes_name", ds), cfg["attribute_name"])
        for ds, cfg in (config or {}).items()
    }
