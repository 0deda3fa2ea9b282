"""Multiscale loss: an inner loss on the native grid and on coarser grids.

Port of ``anemoi_tpu.training.losses.multiscale`` (``_Projection``,
``MultiscaleLossWrapper``, ``build_multiscale_loss``).  Each coarse scale
projects pred and target through a row-normalised ``SparseProjector``
(``ops/sparse_projector.py``) onto a coarser node set and evaluates the
inner loss there; the result is the scale-weighted mean.  NaN targets are
zero-filled in both tensors before the projection, so they cancel in the
error instead of spreading over a coarse cell.  Scalers bound to the grid
dim are sized for the native grid and are dropped at the coarse scales.
The projections give float32 under bf16 (their weights are float32), so the
coarse scales' inner loss sees float32, as in the JAX package.

The JAX wrapper takes no ``mask`` (the imputer's loss mask), so it defines
no multiscale loss under an imputer: here a ``mask`` that is not None
raises, and ``make_step_fns`` refuses the pair before any step (ROADMAP
Queue 3).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from anemoi_tpu_torch.ops.sparse_projector import SparseProjector
from anemoi_tpu_torch.training.losses.base import BaseLoss, ScaleTensor


class _Projection(SparseProjector):
    """Row-normalised projection ``[.., grid, V] -> [.., coarse, V]`` with
    its scale's loss weight."""

    def __init__(self, edge_index, weights, num_coarse: int, scale_weight: float):
        super().__init__(edge_index, weights, num_coarse, row_normalize=True)
        self.scale_weight = float(scale_weight)


class MultiscaleLossWrapper(BaseLoss):
    """Weighted mean of an inner loss over the native and coarsened grids."""

    def __init__(self, inner: BaseLoss, projections: List[_Projection],
                 native_weight: float = 1.0, grid_scaler_names: Sequence[str] = (),
                 scalers: Optional[ScaleTensor] = None, ignore_nans: bool = True):
        super().__init__(scalers=scalers, ignore_nans=ignore_nans)
        self.inner = inner
        self.projections = list(projections)
        self.native_weight = float(native_weight)
        self.grid_scaler_names = list(grid_scaler_names)

    def to(self, device) -> "MultiscaleLossWrapper":
        super().to(device)
        self.inner.to(device)
        return self

    def __call__(self, pred: torch.Tensor, target: torch.Tensor, squash: bool = True,
                 scaler_subset: Optional[Sequence[str]] = None,
                 without_scalers: Optional[Sequence[str]] = None,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if mask is not None:
            raise ValueError("MultiscaleLossWrapper takes no imputer mask (ROADMAP Queue 3)")
        total, norm = 0.0, 0.0
        if self.native_weight:
            total = self.native_weight * self.inner(
                pred, target, squash=squash, scaler_subset=scaler_subset,
                without_scalers=without_scalers)
            norm += self.native_weight
        if self.projections:
            skip = sorted(set(without_scalers or ()) | set(self.grid_scaler_names))
            p, t = pred, target
            if self.ignore_nans:
                # zero-fill NaN targets in both tensors: they cancel in the error
                keep = ~torch.isnan(target)
                zero = torch.zeros((), dtype=pred.dtype, device=pred.device)
                p = torch.where(keep, pred, zero)
                t = torch.where(keep, target, zero.to(target.dtype))
            for proj in self.projections:
                total = total + proj.scale_weight * self.inner(
                    proj(p), proj(t), squash=squash, scaler_subset=scaler_subset,
                    without_scalers=skip)
                norm += proj.scale_weight
        return total / max(norm, 1e-12)

    @property
    def name(self) -> str:
        return f"multiscale_{self.inner.name}"


def build_multiscale_loss(config: dict, scalers=None, graph=None,
                          dataset: str = "data") -> MultiscaleLossWrapper:
    """From ``{"name": "MultiscaleLossWrapper", "loss": {<inner>},
    "native_weight": 1.0, "scales": [{"nodes": "coarse", "weight": 0.5,
    "weight_attribute": "gauss_weight"}, ...]}``: each scale projects through
    the graph's ``(dataset, nodes)`` edge set (dst-sorted), weighted by the
    attribute or by 1; a scale may instead give ``edge_index``, ``weights``
    and ``num_coarse`` directly.  Scalers whose dims hold ``grid`` are
    dropped at the coarse scales."""
    from anemoi_tpu_torch.training.losses.base import get_loss_function

    cfg = dict(config)
    cfg.pop("name", None)
    inner = get_loss_function(cfg.pop("loss", {"name": "WeightedMSELoss"}), scalers)
    grid_names = [n for n, (dims, _) in (scalers or {}).items() if "grid" in tuple(dims)]
    projections = []
    for sc in cfg.pop("scales", []):
        if "edge_index" in sc:
            projections.append(_Projection(sc["edge_index"], sc["weights"],
                                           int(sc["num_coarse"]), sc.get("weight", 1.0)))
            continue
        if graph is None:
            raise ValueError("MultiscaleLossWrapper scales need the graph")
        nodes = sc["nodes"]
        es = graph[(dataset, nodes)]
        attr = sc.get("weight_attribute")
        w = (np.asarray(es.attributes[attr]).reshape(-1) if attr
             else np.ones(es.edge_index.shape[1], np.float32))
        projections.append(_Projection(es.edge_index, w, graph[nodes].num_nodes,
                                       sc.get("weight", 1.0)))
    return MultiscaleLossWrapper(
        inner=inner, projections=projections,
        native_weight=float(cfg.pop("native_weight", 1.0)),
        grid_scaler_names=grid_names, ignore_nans=bool(cfg.pop("ignore_nans", True)),
    )
