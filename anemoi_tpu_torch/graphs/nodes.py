"""Node builders and node attributes.

Copy of ``anemoi_tpu.graphs.nodes``, trimmed to the builders the flagship
recipe and the packaged ``multi_scale`` graph use.  Builders return
``(lat, lon)`` coordinates in radians; attributes return ``[N, k]`` float
arrays.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial import SphericalVoronoi

from anemoi_tpu_torch.graphs.generate.gaussian import (
    full_gaussian_grid,
    octahedral_gaussian_grid,
    reduced_gaussian_grid,
)
from anemoi_tpu_torch.graphs.generate.icosahedron import create_tri_nodes
from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.graphs.transforms import latlon_rad_to_xyz


def normalise(values: np.ndarray, norm: Optional[str]) -> np.ndarray:
    if norm is None or norm == "none":
        return values
    if norm == "l1":
        return values / np.sum(values)
    if norm == "l2":
        return values / np.linalg.norm(values)
    if norm == "unit-max":
        return values / np.amax(values)
    if norm == "unit-range":
        lo, hi = np.amin(values), np.amax(values)
        rng = hi - lo if hi > lo else 1.0
        return (values - lo) / rng
    if norm == "unit-std":
        std = np.std(values)
        return values if std == 0 else values / std
    raise ValueError(f"Unknown norm '{norm}'")


def reduced_gaussian_nodes(grid: str) -> np.ndarray:
    """Gaussian grids by name: 'o32'/'o96' (octahedral), 'n320' (reduced),
    'f64' (full)."""
    kind, n = grid[0].lower(), int(grid[1:])
    if kind == "o":
        return octahedral_gaussian_grid(n)
    if kind == "n":
        return reduced_gaussian_grid(n)
    if kind == "f":
        return full_gaussian_grid(n)
    raise ValueError(f"Unknown Gaussian grid spec '{grid}' (expected o/n/f + number)")


def tri_nodes(resolution: int) -> np.ndarray:
    """Triangular icosphere nodes."""
    return create_tri_nodes(resolution)


def cosine_lat_weights(
    graph: Graph,
    nodes_name: str,
    min_value: float = 1e-3,
    max_value: float = 1.0,
    norm: Optional[str] = None,
) -> np.ndarray:
    """(max-min) * cos(lat) + min."""
    lat = graph[nodes_name].coords[:, 0]
    w = (max_value - min_value) * np.cos(lat) + min_value
    return normalise(w.astype(np.float32)[:, None], norm)


def spherical_area_weights(
    graph: Graph,
    nodes_name: str,
    norm: Optional[str] = "unit-max",
    fill_value: float = 0.0,
) -> np.ndarray:
    """Voronoi cell area of each node on the unit sphere (scipy's
    ``SphericalVoronoi``); nodes without a region get ``fill_value``."""
    points = latlon_rad_to_xyz(graph[nodes_name].coords)
    sv = SphericalVoronoi(points, radius=1.0, center=np.zeros(3))
    mask = np.array([bool(r) for r in sv.regions])
    sv.regions = [r for r in sv.regions if r]
    result = np.full(points.shape[0], fill_value, dtype=np.float64)
    result[mask] = sv.calculate_areas()
    return normalise(result.astype(np.float32)[:, None], norm)


NODE_BUILDERS = {
    "ReducedGaussianGridNodes": reduced_gaussian_nodes,
    "TriNodes": tri_nodes,
}
NODE_ATTRIBUTES = {"CosineLatWeightedAttribute": cosine_lat_weights,
                   "SphericalAreaWeights": spherical_area_weights}


def _lookup(table: Dict, kind: str, config: Dict):
    cfg = dict(config)
    name = cfg.pop("name", None)
    if name not in table:
        raise NotImplementedError(
            f"{kind} '{name}' is not ported to anemoi_tpu_torch (known: {sorted(table)})"
        )
    return table[name], cfg


def build_nodes(config: Dict) -> np.ndarray:
    fn, cfg = _lookup(NODE_BUILDERS, "node builder", config)
    return fn(**cfg)


def build_node_attribute(graph: Graph, nodes_name: str, config: Dict) -> np.ndarray:
    fn, cfg = _lookup(NODE_ATTRIBUTES, "node attribute", config)
    return fn(graph=graph, nodes_name=nodes_name, **cfg)
