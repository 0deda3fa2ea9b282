"""Loss-weight scaler builders.

Port of ``anemoi_tpu.training.losses.scalers``: ``_apply_norm``,
``GraphNodeAttributeScaler`` (grid weights from a graph node attribute),
``GeneralVariableLossScaler`` and ``VariableMaskingLossScaler``
(per-variable weights), the ``Linear``/``Relu``/``Polynomial``/``No``
``VariableLevelScaler`` (pressure-level weights, filtered to a variable
group resolved by ``ExtractVariableGroupAndLevel``) and ``create_scalers``,
with a registry of its own.  Each scaler is ``(dims tuple, numpy array)``.
Every other scaler name raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.utils.variables_metadata import ExtractVariableGroupAndLevel

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


def _extractor(
    metadata_extractor: Optional[ExtractVariableGroupAndLevel],
) -> ExtractVariableGroupAndLevel:
    return metadata_extractor or ExtractVariableGroupAndLevel({"default": "sfc"})


@register_scaler("GeneralVariableLossScaler")
def general_variable_scaler(
    *,
    data_indices,
    weights: Optional[Dict[str, float]] = None,
    default: float = 1.0,
    metadata_extractor: Optional[ExtractVariableGroupAndLevel] = None,
    norm: Optional[str] = None,
    **_,
) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Per-variable weights in model-output order; a param key (``q``)
    matches every level of it (``q_850``)."""
    weights = dict(weights or {})
    default = float(weights.pop("default", default))
    ex = _extractor(metadata_extractor)
    names = data_indices.model.output.ordered_names
    out = np.full(len(names), default, dtype=np.float32)
    for i, name in enumerate(names):
        param = ex.get_param(name)
        if name in weights:
            out[i] = weights[name]
        elif param in weights:
            out[i] = weights[param]
    return ("variable",), _apply_norm(out, norm)


@register_scaler("VariableMaskingLossScaler")
def variable_masking_scaler(
    *,
    data_indices,
    variables: List[str],
    invert: bool = False,
    metadata_extractor: Optional[ExtractVariableGroupAndLevel] = None,
    norm: Optional[str] = None,
    **_,
) -> Tuple[Tuple[str, ...], np.ndarray]:
    """Zero the listed variables in the loss (``invert``: keep only them)."""
    return general_variable_scaler(
        data_indices=data_indices,
        weights=dict.fromkeys(variables, 0.0 if not invert else 1.0),
        default=1.0 if not invert else 0.0,
        metadata_extractor=metadata_extractor,
        norm=norm,
    )


def _level_scaler(kind: str):
    def build(
        *,
        data_indices,
        slope: float = 0.001,
        y_intercept: float = 0.2,
        group: Optional[str] = None,
        metadata_extractor: Optional[ExtractVariableGroupAndLevel] = None,
        norm: Optional[str] = None,
        **_,
    ) -> Tuple[Tuple[str, ...], np.ndarray]:
        """Weights by pressure level: exactly the configured ``group`` (whose
        variables must carry a level), or every levelled variable when no
        group is set; the others keep 1."""
        ex = _extractor(metadata_extractor)
        names = data_indices.model.output.ordered_names
        out = np.ones(len(names), dtype=np.float32)
        for i, name in enumerate(names):
            vgroup, _, level = ex.get_group_and_level(name)
            if group is not None:
                if vgroup != group:
                    continue
                if kind != "none" and level is None:
                    raise ValueError(f"Variable {name} in group {group!r} has no level to scale.")
            elif level is None:
                continue
            if kind == "linear":
                out[i] = level * slope + y_intercept
            elif kind == "relu":
                out[i] = max(y_intercept, level * slope)
            elif kind == "poly":
                out[i] = (slope * level) ** 2 + y_intercept
        return ("variable",), _apply_norm(out, norm)

    return build


register_scaler("LinearVariableLevelScaler")(_level_scaler("linear"))
register_scaler("ReluVariableLevelScaler")(_level_scaler("relu"))
register_scaler("PolynomialVariableLevelScaler")(_level_scaler("poly"))
register_scaler("NoVariableLevelScaler")(_level_scaler("none"))


def create_scalers(
    configs: Optional[Dict[str, dict]],
    *,
    graph: Optional[Graph] = None,
    data_indices=None,
    statistics: Optional[Dict[str, np.ndarray]] = None,
    variable_groups: Optional[Dict[str, object]] = None,
    metadata_variables: Optional[Dict[str, dict]] = None,
    **_,
) -> Dict[str, Tuple[Tuple[str, ...], np.ndarray]]:
    """Build every configured scaler: ``{name: {"name": <scaler>, ...}}`` ->
    ``{name: (dims, array)}`` for ``get_loss_function``.  ``variable_groups``
    (``training.variable_groups``) and the dataset's ``metadata_variables``
    feed the group/level extractor the variable scalers share."""
    extractor = ExtractVariableGroupAndLevel(
        variable_groups or {"default": "sfc"}, metadata_variables
    )
    out: Dict[str, Tuple[Tuple[str, ...], np.ndarray]] = {}
    for name, cfg in (configs or {}).items():
        if cfg is None:  # a preset nulling out an inherited scaler
            continue
        cfg = dict(cfg)
        kind = cfg.pop("name", None)
        if kind not in SCALERS:
            raise NotImplementedError(f"scaler '{kind}' is not ported to anemoi_tpu_torch")
        out[name] = SCALERS[kind](
            **cfg, graph=graph, data_indices=data_indices, statistics=statistics,
            metadata_extractor=extractor,
        )
    return out
