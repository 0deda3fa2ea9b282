"""Node builders and node attributes.

Copy of ``anemoi_tpu.graphs.nodes``, trimmed to the builders the flagship
recipe and the packaged ``multi_scale``, ``limited_area`` and
``stretched_grid`` graphs use.  Builders return ``(lat, lon)`` coordinates
in radians; attributes return ``[N, k]`` float arrays or boolean masks.

Nearest-node distances (``CutOutMask``, ``LimitedAreaTriNodes``) come from
``scipy.spatial.cKDTree`` on unit-sphere cartesian coordinates, turned
into arc lengths by ``2 arcsin(chord / 2)``: the JAX package queries
scikit-learn's haversine ``BallTree``, which the GPU machine does not have.
"""

from __future__ import annotations

from typing import Dict, Optional

import inspect

import numpy as np
from scipy.spatial import SphericalVoronoi, cKDTree

from anemoi_tpu_torch.graphs.generate.gaussian import (
    full_gaussian_grid,
    octahedral_gaussian_grid,
    reduced_gaussian_grid,
)
from anemoi_tpu_torch.graphs.generate.icosahedron import create_tri_nodes
from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.graphs.transforms import latlon_rad_to_xyz

EARTH_RADIUS_KM = 6371.0


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


def _arc_to_nearest(ref: np.ndarray, coords: np.ndarray, k: int = 1) -> np.ndarray:
    """[N, k] great-circle distances (radians of arc) from each of ``coords``
    to its ``k`` nearest ``ref`` nodes, nearest first."""
    chord, _ = cKDTree(latlon_rad_to_xyz(ref)).query(latlon_rad_to_xyz(coords), k=k)
    chord = np.asarray(chord).reshape(len(coords), k)
    return 2.0 * np.arcsin(np.clip(chord / 2.0, 0.0, 1.0))


def stretched_tri_nodes(
    global_resolution: int,
    lam_resolution: int,
    reference_node_name: Optional[str] = None,
    centre: Optional[list] = None,
    radius_deg: float = 10.0,
) -> np.ndarray:
    """Stretched mesh: the ``global_resolution`` icosphere outside a
    spherical cap of ``radius_deg`` around ``centre`` (lat, lon degrees),
    the ``lam_resolution`` one inside it; coarse nodes first."""
    coarse = create_tri_nodes(global_resolution)
    fine = create_tri_nodes(lam_resolution)
    c = np.deg2rad(np.asarray(centre if centre is not None else [0.0, 0.0], dtype=np.float64))
    cap_cos = np.cos(np.deg2rad(radius_deg))
    c_xyz = latlon_rad_to_xyz(c[None, :])[0]

    def in_cap(coords: np.ndarray) -> np.ndarray:
        return latlon_rad_to_xyz(coords) @ c_xyz > cap_cos

    return np.concatenate([coarse[~in_cap(coarse)], fine[in_cap(fine)]], axis=0)


def limited_area_tri_nodes(
    resolution: int,
    reference_node_name: str,
    margin_radius_km: float = 100.0,
    graph: Optional[Graph] = None,
) -> np.ndarray:
    """The icosphere clipped to the nodes no farther than
    ``margin_radius_km`` from a node of ``reference_node_name``, a node set
    built earlier in the recipe."""
    if graph is None or reference_node_name not in graph.node_names():
        raise ValueError(
            f"LimitedAreaTriNodes needs '{reference_node_name}' built earlier in the recipe")
    mesh = create_tri_nodes(resolution)
    dist = _arc_to_nearest(graph[reference_node_name].coords, mesh)[:, 0]
    keep = dist <= margin_radius_km / EARTH_RADIUS_KM
    if not keep.any():
        raise ValueError("LimitedAreaTriNodes: no mesh nodes inside the area")
    return mesh[keep]


def cutout_mask(
    graph: Graph,
    nodes_name: str,
    reference_node_name: str,
    min_distance_km: float = 0.0,
) -> np.ndarray:
    """True where a node lies outside the footprint of the reference nodes:
    farther from all of them than 1.5 times the largest distance from a
    reference node to its nearest other one (at least ``min_distance_km``)."""
    coords = graph[nodes_name].coords
    ref = graph[reference_node_name].coords
    dist = _arc_to_nearest(ref, coords)[:, 0]
    d_ref = _arc_to_nearest(ref, ref, k=2)
    footprint = max(np.max(d_ref[:, 1]) * 1.5, min_distance_km / EARTH_RADIUS_KM)
    return (dist > footprint)[:, None]


def area_mask(
    graph: Graph,
    nodes_name: str,
    lat_min: float = -90.0,
    lat_max: float = 90.0,
    lon_min: float = -180.0,
    lon_max: float = 180.0,
) -> np.ndarray:
    """True for the nodes inside a lat/lon box (degrees, bounds included)."""
    lat, lon = np.rad2deg(graph[nodes_name].coords).T
    inside = (lat >= lat_min) & (lat <= lat_max) & (lon >= lon_min) & (lon <= lon_max)
    return inside[:, None]


def apply_boolean_op(graph: Graph, nodes_name: str, op: str, attributes: list) -> np.ndarray:
    """``and``/``or`` over existing mask attributes, or ``not`` of one."""
    masks = [graph[nodes_name].attributes[a].astype(bool) for a in attributes]
    if op == "and":
        return np.logical_and.reduce(masks)
    if op == "or":
        return np.logical_or.reduce(masks)
    if op == "not":
        (m,) = masks
        return ~m
    raise ValueError(f"Unknown boolean op '{op}'")


NODE_BUILDERS = {
    "ReducedGaussianGridNodes": reduced_gaussian_nodes,
    "TriNodes": tri_nodes,
    "LimitedAreaTriNodes": limited_area_tri_nodes,
    "StretchedTriNodes": stretched_tri_nodes,
}
NODE_ATTRIBUTES = {"CosineLatWeightedAttribute": cosine_lat_weights,
                   "SphericalAreaWeights": spherical_area_weights,
                   "CutOutMask": cutout_mask,
                   "AreaMask": area_mask,
                   "BooleanOp": apply_boolean_op}


def _lookup(table: Dict, kind: str, config: Dict):
    cfg = dict(config)
    name = cfg.pop("name", None)
    if name not in table:
        raise NotImplementedError(
            f"{kind} '{name}' is not ported to anemoi_tpu_torch (known: {sorted(table)})"
        )
    return table[name], cfg


def build_nodes(config: Dict, graph: Optional[Graph] = None) -> np.ndarray:
    """The builder's coordinates; a builder that clips against an earlier
    node set (``LimitedAreaTriNodes``) declares ``graph`` and gets it."""
    fn, cfg = _lookup(NODE_BUILDERS, "node builder", config)
    if "graph" in inspect.signature(fn).parameters:
        cfg["graph"] = graph
    return fn(**cfg)


def build_node_attribute(graph: Graph, nodes_name: str, config: Dict) -> np.ndarray:
    fn, cfg = _lookup(NODE_ATTRIBUTES, "node attribute", config)
    return fn(graph=graph, nodes_name=nodes_name, **cfg)
