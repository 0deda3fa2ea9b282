"""Edge builders and edge attributes.

Copy of ``anemoi_tpu.graphs.edges``, trimmed to the builders the flagship
recipe uses.  Distance queries run on unit-sphere cartesian coordinates with
``scipy.spatial.cKDTree`` (the JAX package uses scikit-learn, which the GPU
machine does not have).  Neighbours come back sorted by distance in both, so
the edge order within a destination agrees except where two distances tie.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial import cKDTree

from anemoi_tpu_torch.graphs.generate.icosahedron import multi_scale_edge_index
from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.graphs.nodes import _lookup, normalise
from anemoi_tpu_torch.graphs.transforms import (
    edge_directions,
    great_circle_distance,
    latlon_rad_to_xyz,
)

EARTH_RADIUS_KM = 6371.0


def _kneighbors(src_xyz: np.ndarray, dst_xyz: np.ndarray, k: int, spare: int = 4):
    """(dist, idx) [num_dst, k] of each destination's k nearest sources,
    nearest first; equal distances go to the lower source index.

    Symmetric grids put many sources at exactly the same distance, and
    cKDTree breaks such ties in tree order.  Querying ``spare`` extra
    neighbours and re-sorting by (distance, index) makes the choice
    deterministic (and, on the grids tested, the same as scikit-learn's)."""
    n_src = len(src_xyz)
    if k > n_src:
        raise ValueError(f"asked for {k} neighbours among {n_src} nodes")
    kq = min(k + spare, n_src)
    dist, idx = cKDTree(src_xyz).query(dst_xyz, k=kq)
    dist, idx = dist.reshape(len(dst_xyz), kq), idx.reshape(len(dst_xyz), kq)
    order = np.lexsort((idx, dist), axis=-1)[:, :k]
    return np.take_along_axis(dist, order, 1), np.take_along_axis(idx, order, 1)


def _reference_distance(coords: np.ndarray) -> float:
    """Max nearest-neighbour chord distance among nodes -- the 'grid reference
    distance' used to scale cutoff radii."""
    xyz = latlon_rad_to_xyz(coords)
    dist, _ = _kneighbors(xyz, xyz, 2)
    return float(dist[:, 1].max())


def cutoff_edges(
    graph: Graph,
    source_name: str,
    target_name: str,
    cutoff_factor: Optional[float] = None,
    cutoff_distance_km: Optional[float] = None,
    max_num_neighbours: int = 64,
) -> np.ndarray:
    """Connect each target node to all source nodes within a cutoff radius.

    Radius = cutoff_factor * target grid reference distance, or an explicit
    km distance.
    """
    if (cutoff_factor is None) == (cutoff_distance_km is None):
        raise ValueError("Provide exactly one of cutoff_factor / cutoff_distance_km.")
    src_xyz = latlon_rad_to_xyz(graph[source_name].coords)
    dst_xyz = latlon_rad_to_xyz(graph[target_name].coords)
    if cutoff_distance_km is not None:
        radius = 2.0 * np.sin(cutoff_distance_km / EARTH_RADIUS_KM / 2.0)  # arc -> chord
    else:
        radius = cutoff_factor * _reference_distance(graph[target_name].coords)
    dist, idx = _kneighbors(src_xyz, dst_xyz, max_num_neighbours)
    within = dist <= radius
    dst = np.repeat(np.arange(len(dst_xyz)), within.sum(axis=1))
    src = idx[within]
    return np.stack([src, dst]).astype(np.int64)


def knn_edges(
    graph: Graph, source_name: str, target_name: str, num_nearest_neighbours: int = 3
) -> np.ndarray:
    """Connect each target node to its k nearest source nodes."""
    src_xyz = latlon_rad_to_xyz(graph[source_name].coords)
    dst_xyz = latlon_rad_to_xyz(graph[target_name].coords)
    _, idx = _kneighbors(src_xyz, dst_xyz, num_nearest_neighbours)
    dst = np.repeat(np.arange(len(dst_xyz)), num_nearest_neighbours)
    return np.stack([idx.ravel(), dst]).astype(np.int64)


def multi_scale_edges(
    graph: Graph,
    source_name: str,
    target_name: str,
    x_hops: int = 1,
    resolution: Optional[int] = None,
    scale_resolutions: Optional[list] = None,
) -> np.ndarray:
    """Icosahedral multi-scale edges over a ``TriNodes`` set (10*4^r+2 nodes);
    coarse-level adjacency is unioned across ``scale_resolutions``."""
    if source_name != target_name:
        raise ValueError("MultiScaleEdges connect a node set to itself.")
    num_nodes = graph[source_name].num_nodes
    if resolution is None:
        resolution = int(round(np.log(max(num_nodes - 2, 1) / 10.0) / np.log(4.0)))
    if 10 * 4**resolution + 2 != num_nodes:
        raise ValueError(
            f"MultiScaleEdges: node set '{source_name}' has {num_nodes} nodes, not a "
            f"tri mesh at resolution {resolution}"
        )
    return multi_scale_edge_index(resolution, scale_resolutions, x_hops)


def _edge_coords(graph: Graph, source_name: str, target_name: str, edge_index: np.ndarray):
    src = graph[source_name].coords[edge_index[0]]
    dst = graph[target_name].coords[edge_index[1]]
    return src, dst


def edge_length(
    graph: Graph, source_name: str, target_name: str, edge_index: np.ndarray,
    norm: Optional[str] = "unit-max",
) -> np.ndarray:
    """Great-circle length per edge."""
    src, dst = _edge_coords(graph, source_name, target_name, edge_index)
    d = great_circle_distance(src, dst)
    return normalise(d.astype(np.float32)[:, None], norm)


def edge_direction(
    graph: Graph, source_name: str, target_name: str, edge_index: np.ndarray,
    norm: Optional[str] = "unit-std",
) -> np.ndarray:
    """(dlat, dlon) of the source in the destination's local frame."""
    src, dst = _edge_coords(graph, source_name, target_name, edge_index)
    d = edge_directions(src, dst)
    return normalise(d.astype(np.float32), norm)


EDGE_BUILDERS = {
    "CutOffEdges": cutoff_edges,
    "KNNEdges": knn_edges,
    "MultiScaleEdges": multi_scale_edges,
}
EDGE_ATTRIBUTES = {"EdgeLength": edge_length, "EdgeDirection": edge_direction}


def build_edges(graph: Graph, config: Dict) -> np.ndarray:
    fn, cfg = _lookup(EDGE_BUILDERS, "edge builder", config)
    return fn(graph=graph, **cfg)


def build_edge_attribute(
    graph: Graph, source_name: str, target_name: str, edge_index: np.ndarray, config: Dict
) -> np.ndarray:
    fn, cfg = _lookup(EDGE_ATTRIBUTES, "edge attribute", config)
    return fn(
        graph=graph, source_name=source_name, target_name=target_name,
        edge_index=edge_index, **cfg,
    )
