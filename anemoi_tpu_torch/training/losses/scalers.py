"""Loss-weight scaler builders.

Port of ``anemoi_tpu.training.losses.scalers``: ``_apply_norm``,
``GraphNodeAttributeScaler`` and ``ReweightedGraphNodeAttributeScaler``
(grid weights from a graph node attribute), ``GeneralVariableLossScaler``
and ``VariableMaskingLossScaler`` (per-variable weights), the
``Linear``/``Relu``/``Polynomial``/``No`` ``VariableLevelScaler``
(pressure-level weights, filtered to a variable group resolved by
``ExtractVariableGroupAndLevel``), the ``No``/``Stdev``/``Var``
``TendencyScaler`` (and the legacy ``TendencyScaler``) from the dataset's
tendency statistics, the ``TimeStep``/``UniformTimeStep``/``LeadTimeDecay``
scalers on the time dim, ``SpectralDimensionScaler`` and
``create_scalers``, with a registry of its own.  Each scaler is ``(dims
tuple, numpy array)``.
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


@register_scaler("ReweightedGraphNodeAttributeScaler")
def reweighted_graph_node_attribute_scaler(
    *,
    graph: Graph,
    nodes_name: str = "data",
    attribute_name: str = "area_weight",
    scaling_mask_attribute_name: str,
    weight_frac_of_total: float,
    inverse: bool = False,
    norm: Optional[str] = "unit-sum",
    **_,
) -> Tuple[Tuple[str, ...], np.ndarray]:
    """The node attribute with the nodes of a boolean mask attribute
    (``inverse``: the others) reweighted so that they hold
    ``weight_frac_of_total`` of the total weight, e.g. a LAM's interior."""
    nodes = graph[nodes_name]
    w = np.asarray(nodes.attributes[attribute_name], dtype=np.float64).reshape(-1).copy()
    if scaling_mask_attribute_name not in nodes.attributes:
        bool_attrs = [k for k, v in nodes.attributes.items() if np.asarray(v).dtype == np.bool_]
        raise KeyError(f"scaling_mask_attribute_name {scaling_mask_attribute_name!r} not found "
                       f"in graph - available boolean node attributes: {bool_attrs}")
    mask = np.asarray(nodes.attributes[scaling_mask_attribute_name]).reshape(-1).astype(bool)
    if inverse:
        mask = ~mask
    if not 0.0 < weight_frac_of_total < 1.0:
        raise ValueError("weight_frac_of_total must be in (0, 1)")
    n_masked = int(mask.sum())
    if n_masked:
        w[mask] = (weight_frac_of_total / (1.0 - weight_frac_of_total) * w[~mask].sum()
                   / n_masked)
    return ("grid",), _apply_norm(w.astype(np.float32), norm)


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


def _tendency_scaler(kind: str):
    def build(
        *,
        data_indices,
        statistics_tendencies: Optional[Dict[str, np.ndarray]] = None,
        statistics: Optional[Dict[str, np.ndarray]] = None,
        norm: Optional[str] = None,
        **_,
    ) -> Tuple[Tuple[str, ...], np.ndarray]:
        """Per model-output variable, the state's stdev over its tendency's
        (``stdev``) or its square (``var``); 1 where the dataset has no
        tendency statistics or the tendency's stdev is 0."""
        names = data_indices.model.output.ordered_names
        out = np.ones(len(names), dtype=np.float32)
        if kind != "none" and statistics_tendencies is not None and statistics is not None:
            t_std = np.asarray(statistics_tendencies["stdev"], dtype=np.float64)
            s_std = np.asarray(statistics["stdev"], dtype=np.float64)
            for i, name in enumerate(names):
                j = data_indices.name_to_index[name]
                if t_std[j] > 0:
                    r = float(s_std[j] / t_std[j])
                    out[i] = r if kind == "stdev" else r * r
        return ("variable",), _apply_norm(out, norm)

    return build


register_scaler("NoTendencyScaler")(_tendency_scaler("none"))
register_scaler("StdevTendencyScaler")(_tendency_scaler("stdev"))
register_scaler("VarTendencyScaler")(_tendency_scaler("var"))
register_scaler("TendencyScaler")(_tendency_scaler("stdev"))  # the legacy name


@register_scaler("TimeStepScaler")
def time_step_scaler(*, n_steps: int = 1, gamma: Optional[float] = None,
                     weights: Optional[List[float]] = None, norm: Optional[str] = None, **_):
    """Explicit weights per output step, or the legacy ``gamma ** t``."""
    if weights is not None:
        w = np.asarray(weights, dtype=np.float32)
    else:
        w = (float(gamma if gamma is not None else 1.0) ** np.arange(n_steps)).astype(np.float32)
    return ("time",), _apply_norm(w, norm)


@register_scaler("UniformTimeStepScaler")
def uniform_time_step_scaler(*, n_steps: int = 1, **_):
    """Equal weights of unit sum."""
    return ("time",), np.full(n_steps, 1.0 / n_steps, dtype=np.float32)


@register_scaler("LeadTimeDecayScaler")
def lead_time_decay_scaler(*, output_lead_times: List[int], decay_factor: float,
                           max_lead_time: int, decay_type: str = "linear",
                           inverse: bool = False, norm: Optional[str] = None, **_):
    """Weights that decay (``inverse``: grow) with lead time, of unit sum."""
    if decay_type not in ("exponential", "linear"):
        raise ValueError(f"decay_type {decay_type!r} not supported")
    t = np.asarray(output_lead_times, dtype=np.float64) / float(max_lead_time)
    if decay_type == "exponential":
        w, w_inv = np.exp(-decay_factor * t), 1.0 - np.exp(-decay_factor * t)
    else:
        w, w_inv = 1.0 - decay_factor * t, decay_factor * t
    w = w_inv if inverse else w
    return ("time",), _apply_norm((w / w.sum()).astype(np.float32), norm)


@register_scaler("SpectralDimensionScaler")
def spectral_dimension_scaler(*, n_spectral_modes: int, spectral_dims: Optional[int] = None,
                              norm: Optional[str] = None, **_):
    """``1 / n_spectral_modes`` over the spectral dim, which takes the grid
    dim's place inside the spectral losses."""
    n = int(spectral_dims if spectral_dims is not None else n_spectral_modes)
    return ("grid",), _apply_norm(np.full(n, 1.0 / float(n_spectral_modes), dtype=np.float32),
                                  norm)


def create_scalers(
    configs: Optional[Dict[str, dict]],
    *,
    graph: Optional[Graph] = None,
    data_indices=None,
    statistics: Optional[Dict[str, np.ndarray]] = None,
    statistics_tendencies: Optional[Dict[str, np.ndarray]] = None,
    variable_groups: Optional[Dict[str, object]] = None,
    metadata_variables: Optional[Dict[str, dict]] = None,
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
            statistics_tendencies=statistics_tendencies, metadata_extractor=extractor,
        )
    return out
