"""Edge builders and edge attributes.

Copy of ``anemoi_tpu.graphs.edges``: every builder and attribute of the JAX
package's registries, in the tables ``EDGE_BUILDERS`` and
``EDGE_ATTRIBUTES``.  Distance queries run on unit-sphere cartesian
coordinates with ``scipy.spatial.cKDTree`` (the JAX package uses
scikit-learn, which the GPU machine does not have).  Neighbours come back
sorted by distance in both, so the edge order within a destination agrees
except where two distances tie.  Where the JAX package asserts a node count,
the port raises ``ValueError``.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
from scipy.spatial import cKDTree

from anemoi_tpu_torch.graphs.generate.healpix import healpix_multiscale_edges
from anemoi_tpu_torch.graphs.generate.hexagons import hex_multi_scale_edge_index
from anemoi_tpu_torch.graphs.generate.icon import icon_grid2mesh_edges, icon_multimesh
from anemoi_tpu_torch.graphs.generate.icosahedron import multi_scale_edge_index
from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.graphs.nodes import _lookup, normalise
from anemoi_tpu_torch.graphs.transforms import (
    azimuth,
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


def reversed_knn_edges(
    graph: Graph, source_name: str, target_name: str, num_nearest_neighbours: int = 3
) -> np.ndarray:
    """Connect each SOURCE node to its k nearest target nodes (edges in
    source order)."""
    src_xyz = latlon_rad_to_xyz(graph[source_name].coords)
    dst_xyz = latlon_rad_to_xyz(graph[target_name].coords)
    _, idx = _kneighbors(dst_xyz, src_xyz, num_nearest_neighbours)
    src = np.repeat(np.arange(len(src_xyz)), num_nearest_neighbours)
    return np.stack([src, idx.ravel()]).astype(np.int64)


def mutual_knn_edges(
    graph: Graph, source_name: str, target_name: str, num_nearest_neighbours: int = 3
) -> np.ndarray:
    """The reversed kNN edges that are also forward kNN edges, in the
    reversed set's order."""
    fwd = knn_edges(graph, source_name, target_name, num_nearest_neighbours)
    rev = reversed_knn_edges(graph, source_name, target_name, num_nearest_neighbours)
    n_dst = np.int64(graph[target_name].num_nodes)
    keep = np.isin(rev[0] * n_dst + rev[1], fwd[0] * n_dst + fwd[1])
    return rev[:, keep]


def healpix_multi_scale_edges(
    graph: Graph,
    source_name: str,
    target_name: str,
    scale_resolutions=None,
    resolution: Optional[int] = None,
) -> np.ndarray:
    """HEALPix multi-scale mesh edges over a nested-scheme ``HEALPixNodes``
    set: the 8-neighbour pixel adjacency unioned over ``scale_resolutions``,
    coarse pixels mapped to their first fine descendant."""
    if source_name != target_name:
        raise ValueError("HEALPixMultiScaleEdges connect a node set to itself.")
    num_nodes = graph[source_name].num_nodes
    if resolution is None:
        resolution = int(round(np.log(num_nodes / 12.0) / np.log(4.0)))
        if 12 * 4**resolution != num_nodes:
            raise ValueError(
                f"Cannot infer HEALPix resolution from {num_nodes} nodes; pass resolution=")
    return healpix_multiscale_edges(resolution, scale_resolutions)


def icon_processor_edges(
    graph: Graph,
    source_name: str,
    target_name: str,
    grid_filename: str,
    max_level: Optional[int] = None,
    bidirectional: bool = True,
) -> np.ndarray:
    """Multimesh vertex-vertex edges unioned over refinement levels
    0..max_level, over ``ICONMultiMeshNodes`` of the same grid file and
    ``max_level``."""
    if source_name != target_name:
        raise ValueError("ICON processor edges connect the multimesh to itself.")
    mesh = icon_multimesh(grid_filename, max_level)
    if mesh.num_nodes != graph[source_name].num_nodes:
        raise ValueError(
            f"'{source_name}' has {graph[source_name].num_nodes} nodes but the ICON "
            f"multimesh at max_level={max_level} has {mesh.num_nodes}; build the "
            "nodes with ICONMultiMeshNodes from the same grid_filename/max_level.")
    return mesh.multi_mesh_edges(bidirectional=bidirectional)


def _icon_grid2mesh(graph, cell_name, mesh_name, grid_filename, max_level, cell_max_level):
    """[E, 2] (cell, multimesh vertex) pairs, checked against the node sets."""
    pairs = icon_grid2mesh_edges(grid_filename, max_level, cell_max_level)
    mesh = icon_multimesh(grid_filename, max_level)
    if mesh.num_nodes != graph[mesh_name].num_nodes:
        raise ValueError(
            f"'{mesh_name}' has {graph[mesh_name].num_nodes} nodes but the ICON multimesh "
            f"at max_level={max_level} has {mesh.num_nodes}")
    if int(pairs[:, 0].max()) + 1 != graph[cell_name].num_nodes:
        raise ValueError(f"'{cell_name}' must be ICONCellGridNodes from the same grid file")
    return pairs


def icon_encoder_edges(
    graph: Graph,
    source_name: str,
    target_name: str,
    grid_filename: str,
    max_level: Optional[int] = None,
    cell_max_level: Optional[int] = None,
) -> np.ndarray:
    """Cell -> multimesh-vertex edges: each ICON cell connects to the 3
    vertices of its level-``max_level`` ancestor triangle."""
    pairs = _icon_grid2mesh(graph, source_name, target_name, grid_filename, max_level,
                            cell_max_level)
    return pairs.T.astype(np.int64)


def icon_decoder_edges(
    graph: Graph,
    source_name: str,
    target_name: str,
    grid_filename: str,
    max_level: Optional[int] = None,
    cell_max_level: Optional[int] = None,
) -> np.ndarray:
    """Multimesh-vertex -> cell edges: the encoder edges reversed."""
    pairs = _icon_grid2mesh(graph, target_name, source_name, grid_filename, max_level,
                            cell_max_level)
    return pairs[:, ::-1].T.astype(np.int64)


def multi_scale_edges(
    graph: Graph,
    source_name: str,
    target_name: str,
    x_hops: int = 1,
    resolution: Optional[int] = None,
    scale_resolutions: Optional[list] = None,
    mesh_type: Optional[str] = None,
    depth_children: int = 0,
) -> np.ndarray:
    """Icosahedral multi-scale edges over ``TriNodes`` (10*4^r+2 nodes) or
    ``HexNodes`` (20*4^r nodes); the mesh type is inferred from the node
    count unless ``mesh_type`` ('tri'|'hex') is given.  Coarse-level
    adjacency is unioned across ``scale_resolutions``; ``depth_children``
    (hex only) adds parent-child edges across levels."""
    if source_name != target_name:
        raise ValueError("MultiScaleEdges connect a node set to itself.")
    num_nodes = graph[source_name].num_nodes
    if mesh_type is None or resolution is None:
        r_tri = int(round(np.log(max(num_nodes - 2, 1) / 10.0) / np.log(4.0)))
        r_hex = int(round(np.log(max(num_nodes, 1) / 20.0) / np.log(4.0)))
        if mesh_type == "tri" or (mesh_type is None and 10 * 4**r_tri + 2 == num_nodes):
            mesh_type, resolution = "tri", (resolution if resolution is not None else r_tri)
        elif mesh_type == "hex" or (mesh_type is None and 20 * 4**r_hex == num_nodes):
            mesh_type, resolution = "hex", (resolution if resolution is not None else r_hex)
        else:
            raise ValueError(
                f"Cannot infer tri/hex mesh resolution from {num_nodes} nodes; "
                "pass mesh_type= and resolution=")
    expected = 10 * 4**resolution + 2 if mesh_type == "tri" else 20 * 4**resolution
    if expected != num_nodes:
        raise ValueError(
            f"MultiScaleEdges: node set '{source_name}' has {num_nodes} nodes but a "
            f"{mesh_type} mesh at resolution {resolution} has {expected}")
    if mesh_type == "hex":
        return hex_multi_scale_edge_index(resolution, scale_resolutions, x_hops, depth_children)
    if depth_children != 0:
        raise ValueError("depth_children applies to hex meshes only")
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


def edge_azimuth(
    graph: Graph, source_name: str, target_name: str, edge_index: np.ndarray,
    norm: Optional[str] = None,
) -> np.ndarray:
    """Forward azimuth src -> dst."""
    src, dst = _edge_coords(graph, source_name, target_name, edge_index)
    return normalise(azimuth(src, dst).astype(np.float32)[:, None], norm)


def gaussian_distance_weights(
    graph: Graph, source_name: str, target_name: str, edge_index: np.ndarray,
    sigma_factor: Optional[float] = None, sigma: Optional[float] = None,
    norm: Optional[str] = None,
) -> np.ndarray:
    """``exp(-d^2 / (2 sigma^2))`` of the haversine edge length ``d``.
    ``sigma`` is absolute; ``sigma_factor`` (default 1) scales the mean edge
    length instead.  ``norm: l1`` normalises per target node in float64 (a
    projection's rows sum to 1); other norms act on the whole set."""
    src, dst = _edge_coords(graph, source_name, target_name, edge_index)
    d = great_circle_distance(src, dst)
    if sigma is None:
        sigma = (sigma_factor if sigma_factor is not None else 1.0) * max(float(d.mean()), 1e-12)
    w = np.exp(-0.5 * (d / sigma) ** 2).astype(np.float64)
    if norm == "l1":
        target = edge_index[1]
        sums = np.zeros(graph[target_name].num_nodes, dtype=np.float64)
        np.add.at(sums, target, w)
        return (w / np.maximum(sums[target], 1e-30)).astype(np.float32)[:, None]
    return normalise(w.astype(np.float32)[:, None], norm)


def radial_basis_features(
    graph: Graph, source_name: str, target_name: str, edge_index: np.ndarray,
    num_basis: int = 8, norm: Optional[str] = None,
) -> np.ndarray:
    """Gaussian radial-basis expansion of the edge length: ``num_basis``
    centres evenly from 0 to the longest edge."""
    src, dst = _edge_coords(graph, source_name, target_name, edge_index)
    d = great_circle_distance(src, dst)
    d_max = max(float(d.max()), 1e-12)
    centres = np.linspace(0.0, d_max, num_basis)
    width = d_max / max(num_basis - 1, 1)
    feats = np.exp(-0.5 * ((d[:, None] - centres[None, :]) / width) ** 2)
    return normalise(feats.astype(np.float32), norm)


def directional_harmonics(
    graph: Graph, source_name: str, target_name: str, edge_index: np.ndarray,
    num_harmonics: int = 2, norm: Optional[str] = None,
) -> np.ndarray:
    """sin(k a), cos(k a) of the edge azimuth a for k = 1..num_harmonics."""
    src, dst = _edge_coords(graph, source_name, target_name, edge_index)
    a = azimuth(src, dst)
    k = np.arange(1, num_harmonics + 1)
    feats = np.stack([np.sin(k[None] * a[:, None]), np.cos(k[None] * a[:, None])], axis=-1)
    return normalise(feats.reshape(len(a), -1).astype(np.float32), norm)


EDGE_BUILDERS = {
    "CutOffEdges": cutoff_edges,
    "KNNEdges": knn_edges,
    "ReversedKNNEdges": reversed_knn_edges,
    "MutualKNNEdges": mutual_knn_edges,
    "HEALPixMultiScaleEdges": healpix_multi_scale_edges,
    "ICONTopologicalProcessorEdges": icon_processor_edges,
    "ICONTopologicalEncoderEdges": icon_encoder_edges,
    "ICONTopologicalDecoderEdges": icon_decoder_edges,
    "MultiScaleEdges": multi_scale_edges,
}
EDGE_ATTRIBUTES = {"EdgeLength": edge_length, "EdgeDirection": edge_direction,
                   "Azimuth": edge_azimuth,
                   "GaussianDistanceWeights": gaussian_distance_weights,
                   "RadialBasisFeatures": radial_basis_features,
                   "DirectionalHarmonics": directional_harmonics}


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
