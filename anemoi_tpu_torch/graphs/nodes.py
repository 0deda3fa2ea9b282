"""Node builders and node attributes.

Copy of ``anemoi_tpu.graphs.nodes``: every builder and attribute of the JAX
package's registries, in the tables ``NODE_BUILDERS`` and
``NODE_ATTRIBUTES``.  Builders return ``(lat, lon)`` coordinates in radians;
attributes return ``[N, k]`` float arrays or boolean masks.

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
    regular_latlon_grid,
)
from anemoi_tpu_torch.graphs.generate.healpix import healpix_grid, healpix_grid_nested
from anemoi_tpu_torch.graphs.generate.hexagons import create_hex_nodes
from anemoi_tpu_torch.graphs.generate.icon import (
    icon_cell_selection,
    icon_multimesh,
    load_icon_grid,
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


def latlon_nodes(latitudes, longitudes, units: str = "deg") -> np.ndarray:
    """Nodes from explicit coordinate vectors."""
    coords = np.stack([np.asarray(latitudes, dtype=np.float64),
                       np.asarray(longitudes, dtype=np.float64)], axis=-1)
    return np.deg2rad(coords) if units == "deg" else coords


def npz_file_nodes(npz_file: str, lat_key: str = "latitudes",
                   lon_key: str = "longitudes") -> np.ndarray:
    """Nodes from an .npz file with lat/lon arrays in degrees."""
    data = np.load(npz_file)
    return latlon_nodes(data[lat_key], data[lon_key])


def text_nodes(dataset: str, idx_lon: int = 0, idx_lat: int = 1) -> np.ndarray:
    """Nodes from a whitespace text file of coordinates in degrees, one ROW
    per coordinate: rows ``idx_lat`` and ``idx_lon`` are the latitudes and
    longitudes."""
    data = np.loadtxt(dataset)
    if data.ndim == 1:
        data = data[:, None]
    return latlon_nodes(data[idx_lat, :], data[idx_lon, :])


def xarray_nodes(
    dataset: str,
    lat_key: str = "lat",
    lon_key: str = "lon",
    layout: Optional[str] = None,
) -> np.ndarray:
    """Nodes from coordinate variables of a classic NetCDF-3 file (read with
    scipy).  ``layout``: "grid" treats 1-D lat/lon vectors as regular-grid
    axes (meshgrid), "points" as paired per-point coordinates; by default
    "points" when the vectors have equal length, else "grid".  Degrees
    unless a variable's ``units`` attribute says radian (checked on both
    variables; mixed units are refused)."""
    from scipy.io import netcdf_file

    def _is_radian(var) -> bool:
        units = getattr(var, "units", b"")
        return b"radian" in units if isinstance(units, bytes) else "radian" in units

    with netcdf_file(dataset, "r", mmap=False) as nc:
        for key in (lat_key, lon_key):
            if key not in nc.variables:
                raise KeyError(
                    f"Coordinate variable '{key}' not in {dataset}; available: "
                    f"{sorted(nc.variables)} (pass lat_key=/lon_key=)"
                )
        vlat, vlon = nc.variables[lat_key], nc.variables[lon_key]
        lat = np.array(vlat[:], dtype=np.float64)
        lon = np.array(vlon[:], dtype=np.float64)
        rad_lat, rad_lon = _is_radian(vlat), _is_radian(vlon)
    if rad_lat != rad_lon:
        raise ValueError(
            f"{dataset}: '{lat_key}' and '{lon_key}' disagree on units "
            "(one radian, one degree)"
        )
    if layout is None:
        layout = ("points" if (lat.ndim > 1 or lon.ndim > 1 or len(lat) == len(lon))
                  else "grid")
    if layout == "grid":
        if lat.ndim != 1 or lon.ndim != 1:
            raise ValueError("layout='grid' needs 1-D axes")
        lon, lat = np.meshgrid(lon, lat)
    elif layout != "points":
        raise ValueError(f"layout must be 'grid' or 'points', got '{layout}'")
    coords = np.stack([lat.ravel(), lon.ravel()], axis=-1)
    return coords if rad_lat else np.deg2rad(coords)


def dataset_nodes(dataset: str) -> np.ndarray:
    """Nodes of a dataset on disk (npy or zarr layout), as ``open_dataset``
    reads it."""
    from anemoi_tpu_torch.data.dataset import open_dataset

    ds = open_dataset(dataset)
    return np.stack([ds.latitudes, ds.longitudes], axis=-1)


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


def regular_nodes(resolution: float) -> np.ndarray:
    """Regular lat/lon grid at ``resolution`` degrees, poles excluded."""
    return regular_latlon_grid(resolution)


def tri_nodes(resolution: int) -> np.ndarray:
    """Triangular icosphere nodes."""
    return create_tri_nodes(resolution)


def healpix_nodes(resolution: int, scheme: str = "nested") -> np.ndarray:
    """HEALPix pixel centres; ``resolution`` is log2(nside).  The nested
    scheme (default) is the indexing ``HEALPixMultiScaleEdges`` needs
    (coarse pixel c's first fine descendant is c*4^k); 'ring' keeps the
    analytic ring order."""
    if scheme == "nested":
        return healpix_grid_nested(2**resolution)
    if scheme != "ring":
        raise ValueError(f"unknown HEALPix scheme '{scheme}'")
    return healpix_grid(2**resolution)


def hex_nodes(resolution: int) -> np.ndarray:
    """Hexagonal nodes: the faces of the level-``resolution`` icosphere
    (its Goldberg dual, ``generate/hexagons.py``); pair with
    ``MultiScaleEdges``, which recognises the 20*4^r node count."""
    return create_hex_nodes(resolution)


def icon_multimesh_nodes(grid_filename: str, max_level: Optional[int] = None) -> np.ndarray:
    """ICON multimesh (processor) nodes: the grid file's vertices with
    refinement level <= ``max_level``."""
    return icon_multimesh(grid_filename, max_level).coords


def icon_cell_grid_nodes(grid_filename: str, max_level: Optional[int] = None) -> np.ndarray:
    """ICON data nodes: the cell circumcentres with refinement level <=
    ``max_level``."""
    grid = load_icon_grid(grid_filename)
    sel = icon_cell_selection(grid, max_level)
    return np.stack([grid.clat[sel], grid.clon[sel]], axis=-1)


def uniform_weights(graph: Graph, nodes_name: str, norm: Optional[str] = None) -> np.ndarray:
    return normalise(np.ones((graph[nodes_name].num_nodes, 1), dtype=np.float32), norm)


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


def isolatitude_area_weights(
    graph: Graph, nodes_name: str, norm: Optional[str] = None
) -> np.ndarray:
    """Area of each node's latitude band divided by the nodes in the band."""
    lat = graph[nodes_name].coords[:, 0]
    unique_lats = np.sort(np.unique(lat))
    div = (unique_lats[1:] + unique_lats[:-1]) / 2
    div = np.concatenate([[-np.pi / 2], div, [np.pi / 2]])
    ring_area = 2 * np.pi * EARTH_RADIUS_KM * (np.sin(div[1:]) - np.sin(div[:-1]))
    rings = np.searchsorted(unique_lats, lat)
    counts = np.bincount(rings, minlength=len(unique_lats))
    w = (ring_area / counts)[rings]
    return normalise(w.astype(np.float32)[:, None], norm)


def planar_area_weights(graph: Graph, nodes_name: str, norm: Optional[str] = None) -> np.ndarray:
    """Planar Voronoi areas in (lon, lat) space, for limited-area grids.
    Cells that are unbounded or reach outside the convex hull of the nodes
    get the median of the others."""
    from scipy.spatial import ConvexHull, Delaunay, Voronoi

    planar = graph[nodes_name].coords[:, ::-1]
    vor = Voronoi(planar)
    hull = Delaunay(planar[ConvexHull(planar).vertices])
    areas = np.zeros(len(planar))
    for i, region_idx in enumerate(vor.point_region):
        region = vor.regions[region_idx]
        if -1 in region or len(region) == 0:
            continue
        poly = vor.vertices[region]
        if np.any(hull.find_simplex(poly) < 0):
            continue
        x, y = poly[:, 0], poly[:, 1]
        areas[i] = 0.5 * abs(np.dot(x, np.roll(y, 1)) - np.dot(y, np.roll(x, 1)))
    fill = np.median(areas[areas > 0]) if np.any(areas > 0) else 1.0
    areas[areas == 0] = fill
    return normalise(areas.astype(np.float32)[:, None], norm)


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
    "LatLonNodes": latlon_nodes,
    "NPZFileNodes": npz_file_nodes,
    "TextNodes": text_nodes,
    "XArrayNodes": xarray_nodes,
    "AnemoiDatasetNodes": dataset_nodes,
    "ReducedGaussianGridNodes": reduced_gaussian_nodes,
    "RegularLatLonNodes": regular_nodes,
    "TriNodes": tri_nodes,
    "HEALPixNodes": healpix_nodes,
    "StretchedTriNodes": stretched_tri_nodes,
    "LimitedAreaTriNodes": limited_area_tri_nodes,
    "HexNodes": hex_nodes,
    "ICONMultiMeshNodes": icon_multimesh_nodes,
    "ICONCellGridNodes": icon_cell_grid_nodes,
}
NODE_ATTRIBUTES = {"UniformWeights": uniform_weights,
                   "SphericalAreaWeights": spherical_area_weights,
                   "CosineLatWeightedAttribute": cosine_lat_weights,
                   "IsolatitudeAreaWeights": isolatitude_area_weights,
                   "PlanarAreaWeights": planar_area_weights,
                   "CutOutMask": cutout_mask,
                   "AreaMask": area_mask,
                   "BooleanOp": apply_boolean_op}


def _lookup(table: Dict, kind: str, config: Dict):
    """The factory that ``config['name']`` (or ``_target_``) names, and the
    rest of the config; raises the JAX registry's ``KeyError``s."""
    cfg = dict(config)
    name = cfg.pop("name", None) or cfg.pop("_target_", None)
    if name is None:
        raise KeyError(f"{kind} config needs a 'name' key: {config}")
    if name not in table:
        raise KeyError(f"Unknown {kind} '{name}'. Known: {', '.join(sorted(table))}")
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
