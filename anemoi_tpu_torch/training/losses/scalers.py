"""Loss-weight scaler builders.

Port of ``anemoi_tpu.training.losses.scalers``: ``_apply_norm``,
``GraphNodeAttributeScaler`` (grid weights from a graph node attribute) and
``create_scalers``, with a registry of its own.  Each scaler is ``(dims
tuple, numpy array)``.  Every other scaler name raises
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np

from anemoi_tpu_torch.graphs.graph import Graph

SCALERS: Dict[str, Callable] = {}


def register_scaler(name: str):
    def deco(fn):
        SCALERS[name] = fn
        return fn

    return deco


def _apply_norm(w: np.ndarray, norm: Optional[str]) -> np.ndarray:
    """None keeps the raw values; unit-sum (l1), unit-mean, unit-max."""
    if norm is None:
        return w
    if norm in ("unit-sum", "l1"):
        return w / np.abs(w).sum()
    if norm == "unit-mean":
        return w / np.abs(w).mean()
    if norm == "unit-max":
        return w / np.abs(w).max()
    raise ValueError(f"Unknown scaler norm {norm!r}")


@register_scaler("GraphNodeAttributeScaler")
def graph_node_attribute_scaler(
    *,
    graph: Graph,
    nodes_name: str = "data",
    attribute_name: str = "area_weight",
    inverse: bool = False,
    norm: Optional[str] = "unit-sum",
    **_,
) -> Tuple[Tuple[str, ...], np.ndarray]:
    w = np.asarray(graph[nodes_name].attributes[attribute_name], dtype=np.float32).reshape(-1)
    if inverse:
        w = (~w.astype(bool)).astype(np.float32)
    return ("grid",), _apply_norm(w, norm)


def create_scalers(
    configs: Optional[Dict[str, dict]],
    *,
    graph: Optional[Graph] = None,
    data_indices=None,
    statistics: Optional[Dict[str, np.ndarray]] = None,
    **_,
) -> Dict[str, Tuple[Tuple[str, ...], np.ndarray]]:
    """Build every configured scaler: ``{name: {"name": <scaler>, ...}}`` ->
    ``{name: (dims, array)}`` for ``get_loss_function``."""
    out: Dict[str, Tuple[Tuple[str, ...], np.ndarray]] = {}
    for name, cfg in (configs or {}).items():
        if cfg is None:  # a preset nulling out an inherited scaler
            continue
        cfg = dict(cfg)
        kind = cfg.pop("name", None)
        if kind not in SCALERS:
            raise NotImplementedError(f"scaler '{kind}' is not ported to anemoi_tpu_torch")
        out[name] = SCALERS[kind](
            **cfg, graph=graph, data_indices=data_indices, statistics=statistics
        )
    return out
