"""Every graph builder, attribute and post-processor of the port against the
JAX package's, on inputs each test writes itself.

The port's five tables (``NODE_BUILDERS``, ``NODE_ATTRIBUTES``,
``EDGE_BUILDERS``, ``EDGE_ATTRIBUTES``, ``POST_PROCESSORS``) hold exactly
the names of the JAX registries, and an unknown or missing name raises the
JAX registry's ``KeyError``.  Node builders must give the same coordinates
array for array; node attributes agree within 1e-6; recipes that use the
edge builders, edge attributes and post-processors are built by both
packages and held by ``tests/torch_graph_compare.py:compare_graphs`` (edge
sets equal per destination except at true ties, which the port's
``cKDTree`` and scikit-learn break differently), each within a tie budget
measured on these inputs.  Where the JAX package asserts a node count or a
layout, the port raises ``ValueError``.
"""

import os

import numpy as np
import pytest
from scipy.io import netcdf_file

from anemoi_tpu.data.dataset import save_dataset
from anemoi_tpu.graphs import edges as jax_edges
from anemoi_tpu.graphs import nodes as jax_nodes
from anemoi_tpu.graphs import post_process as jax_post
from anemoi_tpu.graphs.create import GraphCreator as JaxGraphCreator
from anemoi_tpu.graphs.generate import gaussian as jax_gaussian
from anemoi_tpu.graphs.generate import icon as jax_icon
from anemoi_tpu.graphs.graph import Graph as JaxGraph
from anemoi_tpu.graphs.graph import NodeSet as JaxNodeSet
from anemoi_tpu_torch.graphs import edges, nodes, post_process
from anemoi_tpu_torch.graphs.create import GraphCreator
from anemoi_tpu_torch.graphs.generate import gaussian, icon
from anemoi_tpu_torch.graphs.graph import Graph, NodeSet
from tests.torch_graph_compare import compare_graphs
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

EA = {"edge_length": {"name": "EdgeLength"}, "edge_dirs": {"name": "EdgeDirection"}}


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """Coordinate files of every kind the file builders read, and two
    synthetic ICON grids (r2 and r3), written once."""
    tmp = tmp_path_factory.mktemp("graph_inputs")
    rng = np.random.default_rng(0)
    lat = rng.uniform(-80.0, 80.0, 400)
    lon = rng.uniform(-180.0, 180.0, 400)
    out = {"lat": lat, "lon": lon}
    np.savez(tmp / "pts.npz", latitudes=lat, longitudes=lon, la=lat[::-1], lo=lon[::-1])
    out["npz"] = str(tmp / "pts.npz")
    np.savetxt(tmp / "pts.txt", np.stack([lon, lat]))
    out["txt"] = str(tmp / "pts.txt")
    np.savetxt(tmp / "pts_latlon.txt", np.stack([lat, lon]))
    out["txt_latlon"] = str(tmp / "pts_latlon.txt")

    def netcdf(name, lat_v, lon_v, lat_units="degrees_north", lon_units="degrees_east",
               keys=("lat", "lon")):
        path = str(tmp / name)
        with netcdf_file(path, "w") as nc:
            for key, values, units in zip(keys, (lat_v, lon_v), (lat_units, lon_units)):
                nc.createDimension(f"n_{key}", len(values))
                var = nc.createVariable(key, "d", (f"n_{key}",))
                var[:] = values
                var.units = units
        out[name] = path

    netcdf("points.nc", lat[:20], lon[:20])
    netcdf("grid.nc", np.linspace(-60.0, 60.0, 7), np.linspace(0.0, 330.0, 12))
    netcdf("radian.nc", np.deg2rad(lat[:20]), np.deg2rad(lon[:20]), "radian", "radian",
           keys=("latitude", "longitude"))
    netcdf("mixed.nc", np.deg2rad(lat[:20]), lon[:20], "radian", "degrees_east")

    times, n_var = 3, 2
    fields = rng.normal(size=(times, n_var, 1, len(lat))).astype(np.float32)
    save_dataset(str(tmp / "dataset"), fields, ["a", "b"], lat, lon)
    out["dataset"] = str(tmp / "dataset")
    for r in (2, 3):
        out[f"icon{r}"] = str(tmp / f"icon_r{r}.nc")
        icon.write_synthetic_icon_grid(out[f"icon{r}"], r)
    return out


# --- ring tables ---------------------------------------------------------------
@pytest.mark.parametrize("half", [False, True], ids=["full_2n_table", "half_table"])
def test_pl_table_override_matches_jax(tmp_path, monkeypatch, half):
    """With ANEMOI_TPU_PL_TABLES set, both packages read the official pl
    array (a full 2n-ring table or the northern half) before the vendored
    tables: the same rings and the same grid."""
    n = 32
    north = (20 + 4 * np.arange(n)).astype(np.int64)  # not the vendored N32 table
    table = north if half else np.concatenate([north, north[::-1]])
    np.savez(tmp_path / "pl.npz", n32=table)
    monkeypatch.setenv("ANEMOI_TPU_PL_TABLES", str(tmp_path / "pl.npz"))
    rings = gaussian.reduced_ring_lengths(n)
    np.testing.assert_array_equal(rings, jax_gaussian.reduced_ring_lengths(n))
    np.testing.assert_array_equal(rings, np.concatenate([north, north[::-1]]))
    cfg = {"name": "ReducedGaussianGridNodes", "grid": "n32"}
    coords = nodes.build_nodes(dict(cfg))
    assert len(coords) == 2 * int(north.sum())
    np.testing.assert_array_equal(coords, jax_nodes.build_nodes(dict(cfg)))
    # a table without the grid's key leaves the vendored one in charge
    np.savez(tmp_path / "other.npz", n48=table)
    monkeypatch.setenv("ANEMOI_TPU_PL_TABLES", str(tmp_path / "other.npz"))
    np.testing.assert_array_equal(gaussian.reduced_ring_lengths(n),
                                  jax_gaussian.reduced_ring_lengths(n))


# --- the tables and their errors -------------------------------------------------
TABLES = {
    "node builder": (nodes.NODE_BUILDERS, jax_nodes.node_builder_registry),
    "node attribute": (nodes.NODE_ATTRIBUTES, jax_nodes.node_attribute_registry),
    "edge builder": (edges.EDGE_BUILDERS, jax_edges.edge_builder_registry),
    "edge attribute": (edges.EDGE_ATTRIBUTES, jax_edges.edge_attribute_registry),
    "graph post-processor": (post_process.POST_PROCESSORS, jax_post.post_processor_registry),
}


@pytest.mark.parametrize("kind", list(TABLES))
def test_tables_hold_the_jax_registry_names(kind):
    table, registry = TABLES[kind]
    assert registry.kind == kind
    assert sorted(table) == registry.names()


def _port_and_jax_calls(kind, config):
    """Each package's call of ``kind`` on ``config`` over a small graph."""
    g, jg = Graph(), JaxGraph()
    coords = np.deg2rad([[0.0, 0.0], [10.0, 10.0], [-10.0, 20.0]])
    g["data"], jg["data"] = NodeSet(coords), JaxNodeSet(coords)
    ei = np.array([[0, 1], [1, 2]])
    return {
        "node builder": (lambda: nodes.build_nodes(config), lambda: jax_nodes.build_nodes(config)),
        "node attribute": (lambda: nodes.build_node_attribute(g, "data", config),
                           lambda: jax_nodes.build_node_attribute(jg, "data", config)),
        "edge builder": (lambda: edges.build_edges(g, config),
                         lambda: jax_edges.build_edges(jg, config)),
        "edge attribute": (
            lambda: edges.build_edge_attribute(g, "data", "data", ei, config),
            lambda: jax_edges.build_edge_attribute(jg, "data", "data", ei, config)),
        "graph post-processor": (lambda: post_process.apply_post_processor(g, config),
                                 lambda: jax_post.apply_post_processor(jg, config)),
    }[kind]


@pytest.mark.parametrize("kind", list(TABLES))
def test_unknown_and_missing_names_raise_as_jax(kind):
    """A misspelt name raises the JAX registry's KeyError ("Unknown {kind}
    '{name}'. Known: ..."), word for word; so does a config without a
    name, except that the JAX node builders look the name up first (their
    message names 'None')."""
    for config in ({"name": "NoSuchThing"}, {"_target_": "NoSuchThing"}, {"norm": "l1"}):
        ours, theirs = _port_and_jax_calls(kind, config)
        with pytest.raises(KeyError) as mine:
            ours()
        with pytest.raises(KeyError) as ref:
            theirs()
        if "name" in config or "_target_" in config or kind != "node builder":
            assert str(mine.value) == str(ref.value)
        else:
            assert "config needs a 'name' key" in str(mine.value)


# --- node builders ---------------------------------------------------------------
NODE_CASES = {
    "latlon_deg": lambda f: {"name": "LatLonNodes", "latitudes": f["lat"].tolist(),
                             "longitudes": f["lon"].tolist()},
    "latlon_rad": lambda f: {"name": "LatLonNodes", "latitudes": [0.1, -0.2],
                             "longitudes": [1.0, 3.0], "units": "rad"},
    "npz": lambda f: {"name": "NPZFileNodes", "npz_file": f["npz"]},
    "npz_keys": lambda f: {"name": "NPZFileNodes", "npz_file": f["npz"], "lat_key": "la",
                           "lon_key": "lo"},
    "text": lambda f: {"name": "TextNodes", "dataset": f["txt"]},
    "text_rows": lambda f: {"name": "TextNodes", "dataset": f["txt_latlon"], "idx_lon": 1,
                            "idx_lat": 0},
    "xarray_points": lambda f: {"name": "XArrayNodes", "dataset": f["points.nc"]},
    "xarray_grid": lambda f: {"name": "XArrayNodes", "dataset": f["grid.nc"]},
    "xarray_points_as_grid": lambda f: {"name": "XArrayNodes", "dataset": f["points.nc"],
                                        "layout": "grid"},
    "xarray_radian_keys": lambda f: {"name": "XArrayNodes", "dataset": f["radian.nc"],
                                     "lat_key": "latitude", "lon_key": "longitude"},
    "anemoi_dataset": lambda f: {"name": "AnemoiDatasetNodes", "dataset": f["dataset"]},
    "regular_latlon": lambda f: {"name": "RegularLatLonNodes", "resolution": 7.5},
    "healpix_nested": lambda f: {"name": "HEALPixNodes", "resolution": 3},
    "healpix_ring": lambda f: {"name": "HEALPixNodes", "resolution": 3, "scheme": "ring"},
    "hex": lambda f: {"name": "HexNodes", "resolution": 2},
    "icon_multimesh": lambda f: {"name": "ICONMultiMeshNodes", "grid_filename": f["icon3"],
                                 "max_level": 2},
    "icon_multimesh_finest": lambda f: {"name": "ICONMultiMeshNodes",
                                        "grid_filename": f["icon2"]},
    "icon_cells": lambda f: {"name": "ICONCellGridNodes", "grid_filename": f["icon3"]},
}


@pytest.mark.parametrize("case", list(NODE_CASES))
def test_node_builder_matches_jax(files, case):
    cfg = NODE_CASES[case](files)
    ours = nodes.build_nodes(dict(cfg))
    ref = jax_nodes.build_nodes(dict(cfg))
    assert ours.shape == ref.shape and ours.shape[0] > 0
    np.testing.assert_array_equal(ours, ref)


def test_xarray_nodes_refuse_as_jax(files):
    """Mixed units and missing variables raise in both; a 2-D axis for
    ``layout='grid'`` or an unknown layout raises ``ValueError`` in the port
    (the JAX package asserts the first)."""
    for cfg, err in (({"dataset": files["mixed.nc"]}, ValueError),
                     ({"dataset": files["radian.nc"]}, KeyError),
                     ({"dataset": files["points.nc"], "layout": "rows"}, ValueError)):
        cfg = {"name": "XArrayNodes", **cfg}
        with pytest.raises(err) as mine:
            nodes.build_nodes(dict(cfg))
        with pytest.raises(err) as ref:
            jax_nodes.build_nodes(dict(cfg))
        assert str(mine.value) == str(ref.value)


def test_healpix_unknown_scheme_raises():
    with pytest.raises(ValueError, match="HEALPix scheme"):
        nodes.build_nodes({"name": "HEALPixNodes", "resolution": 1, "scheme": "nest"})
    with pytest.raises(AssertionError, match="HEALPix scheme"):
        jax_nodes.build_nodes({"name": "HEALPixNodes", "resolution": 1, "scheme": "nest"})


# --- node attributes -------------------------------------------------------------
def _box_grid():
    """A jittered 1-degree lat/lon box (a limited-area grid)."""
    rng = np.random.default_rng(3)
    lat, lon = np.meshgrid(np.arange(40.0, 52.0), np.arange(-5.0, 9.0), indexing="ij")
    jitter = rng.uniform(-0.2, 0.2, (2,) + lat.shape)
    return np.deg2rad(np.stack([(lat + jitter[0]).ravel(), (lon + jitter[1]).ravel()], -1))


ATTRIBUTE_CASES = {
    "uniform": ({"name": "UniformWeights"}, "o16"),
    "uniform_l1": ({"name": "UniformWeights", "norm": "l1"}, "o16"),
    "isolatitude": ({"name": "IsolatitudeAreaWeights"}, "o16"),
    "isolatitude_unit_max": ({"name": "IsolatitudeAreaWeights", "norm": "unit-max"}, "n32"),
    "isolatitude_healpix": ({"name": "IsolatitudeAreaWeights", "norm": "l1"}, "healpix"),
    "planar": ({"name": "PlanarAreaWeights"}, "box"),
    "planar_unit_max": ({"name": "PlanarAreaWeights", "norm": "unit-max"}, "box"),
}


@pytest.mark.parametrize("case", list(ATTRIBUTE_CASES))
def test_node_attribute_matches_jax(case):
    cfg, grid = ATTRIBUTE_CASES[case]
    if grid == "box":
        coords = _box_grid()
    elif grid == "healpix":
        coords = nodes.build_nodes({"name": "HEALPixNodes", "resolution": 2, "scheme": "ring"})
    else:
        coords = nodes.reduced_gaussian_nodes(grid)
    g, jg = Graph(), JaxGraph()
    g["data"], jg["data"] = NodeSet(coords), JaxNodeSet(coords)
    ours = nodes.build_node_attribute(g, "data", dict(cfg))
    ref = jax_nodes.build_node_attribute(jg, "data", dict(cfg))
    assert ours.shape == ref.shape == (len(coords), 1) and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-6)


# --- recipes: edge builders, edge attributes, post-processors ----------------------
def _data(grid="o16", attributes=None):
    return {"node_builder": {"name": "ReducedGaussianGridNodes", "grid": grid},
            "attributes": attributes or {}}


def _edge(src, dst, builder, attributes=EA):
    return {"source_name": src, "target_name": dst, "edge_builder": builder,
            "attributes": attributes}


def _random(f):
    """The fixture's 400 random points: no two sources tie for a destination."""
    return {"node_builder": {"name": "NPZFileNodes", "npz_file": f["npz"]}}


def _knn(k=3):
    return {"name": "KNNEdges", "num_nearest_neighbours": k}


def _icon(f, **edge_kw):
    grid = {"grid_filename": f["icon3"], "max_level": 2}
    return {
        "nodes": {"data": {"node_builder": {"name": "ICONCellGridNodes",
                                            "grid_filename": f["icon3"]}},
                  "hidden": {"node_builder": {"name": "ICONMultiMeshNodes", **grid}}},
        "edges": [
            _edge("data", "hidden", {"name": "ICONTopologicalEncoderEdges", **grid}),
            _edge("hidden", "hidden", {"name": "ICONTopologicalProcessorEdges", **grid,
                                       **edge_kw}),
            _edge("hidden", "data", {"name": "ICONTopologicalDecoderEdges", **grid}),
        ],
        "post_processors": [{"name": "SortNodesByIncomingDegree", "nodes_name": "hidden"}],
    }


FEATURES = {"azimuth": {"name": "Azimuth"},
            "azimuth_unit_std": {"name": "Azimuth", "norm": "unit-std"},
            "rbf": {"name": "RadialBasisFeatures", "num_basis": 5},
            "harmonics": {"name": "DirectionalHarmonics", "num_harmonics": 3},
            "harmonics_l2": {"name": "DirectionalHarmonics", "norm": "l2"}}
TRI2 = {"node_builder": {"name": "TriNodes", "resolution": 2}}
HEX2 = {"node_builder": {"name": "HexNodes", "resolution": 2}}
HPX2 = {"node_builder": {"name": "HEALPixNodes", "resolution": 2}}

# name -> (recipe from the input files, ties allowed per edge set: measured on
# these inputs, with each tie checked to be one by compare_graphs)
RECIPE_CASES = {
    "reversed_knn": (lambda f: {
        "nodes": {"data": _data(), "hidden": TRI2},
        "edges": [_edge("data", "hidden", {"name": "ReversedKNNEdges",
                                           "num_nearest_neighbours": 3}, FEATURES)]}, 20),
    "mutual_knn": (lambda f: {
        "nodes": {"data": _random(f), "hidden": TRI2},
        "edges": [_edge("hidden", "data", {"name": "MutualKNNEdges",
                                           "num_nearest_neighbours": 6})]}, 0),
    "healpix_multiscale": (lambda f: {
        "nodes": {"data": _data(), "hidden": HPX2},
        "edges": [_edge("data", "hidden", {"name": "CutOffEdges", "cutoff_factor": 0.6}),
                  _edge("hidden", "hidden", {"name": "HEALPixMultiScaleEdges"}, FEATURES),
                  _edge("hidden", "data", _knn())]}, 12),
    "healpix_scales": (lambda f: {
        "nodes": {"hidden": {"node_builder": {"name": "HEALPixNodes", "resolution": 3}}},
        "edges": [_edge("hidden", "hidden", {"name": "HEALPixMultiScaleEdges",
                                             "scale_resolutions": [1, 3]})]}, 0),
    "hex_multiscale": (lambda f: {
        "nodes": {"data": _data(), "hidden": HEX2},
        "edges": [_edge("data", "hidden", {"name": "CutOffEdges", "cutoff_factor": 0.6}),
                  _edge("hidden", "hidden", {"name": "MultiScaleEdges", "x_hops": 2}),
                  _edge("hidden", "data", _knn())],
        "post_processors": [{"name": "SortNodesByIncomingDegree", "nodes_name": "hidden"}]}, 13),
    "hex_depth_children": (lambda f: {
        "nodes": {"hidden": {"node_builder": {"name": "HexNodes", "resolution": 3}}},
        "edges": [_edge("hidden", "hidden", {"name": "MultiScaleEdges", "depth_children": 2,
                                             "scale_resolutions": [0, 1, 3]})]}, 0),
    "tri_mesh_type": (lambda f: {
        "nodes": {"hidden": TRI2},
        "edges": [_edge("hidden", "hidden", {"name": "MultiScaleEdges", "mesh_type": "tri",
                                             "resolution": 2})]}, 0),
    "icon": (lambda f: _icon(f), 0),
    "icon_one_way": (lambda f: _icon(f, bidirectional=False), 0),
    "remove_unconnected": (lambda f: {
        "nodes": {"data": _random(f), "hidden": {
            "node_builder": {"name": "TriNodes", "resolution": 3},
            "attributes": {"south": {"name": "AreaMask", "lat_max": -60.0}}}},
        "edges": [_edge("hidden", "data", _knn(1))],
        "post_processors": [{"name": "RemoveUnconnectedNodes", "nodes_name": "hidden",
                             "ignore": "south", "save_mask_indices_to_attr": "kept"}]}, 0),
    "subset_in_area": (lambda f: {
        "nodes": {"data": _random(f), "hidden": TRI2},
        "edges": [_edge("data", "hidden", {"name": "CutOffEdges", "cutoff_factor": 0.6}),
                  _edge("hidden", "data", _knn())],
        "post_processors": [{"name": "SubsetNodesInArea", "nodes_name": "data",
                             "lat_min": 20.0, "lat_max": 60.0, "lon_min": -30.0,
                             "lon_max": 45.0}]}, 0),
    "sort_by_source": (lambda f: {
        "nodes": {"data": _data(), "hidden": TRI2},
        "edges": [_edge("data", "hidden", {"name": "CutOffEdges", "cutoff_factor": 0.7})],
        "post_processors": [{"name": "SortEdgeIndexBySourceNodes"}]}, 0),
    "file_nodes_knn": (lambda f: {
        "nodes": {"data": {"node_builder": {"name": "NPZFileNodes", "npz_file": f["npz"]},
                           "attributes": {"w": {"name": "PlanarAreaWeights"}}},
                  "hidden": {"node_builder": {"name": "RegularLatLonNodes", "resolution": 30},
                             "attributes": {"u": {"name": "UniformWeights"}}}},
        "edges": [_edge("data", "hidden", {"name": "ReversedKNNEdges",
                                           "num_nearest_neighbours": 2}),
                  _edge("hidden", "data", {"name": "MutualKNNEdges",
                                           "num_nearest_neighbours": 4})]}, 0),
}


@pytest.mark.parametrize("case", list(RECIPE_CASES))
def test_recipe_matches_jax(files, case):
    make, max_ties = RECIPE_CASES[case]
    recipe = make(files)
    g_jax, g_port = JaxGraphCreator(recipe).create(), GraphCreator(recipe).create()
    reversed_sets = [(e["source_name"], e["target_name"]) for e in recipe["edges"]
                     if e["edge_builder"]["name"] == "ReversedKNNEdges"]
    ties = compare_graphs(g_jax, g_port, by_source=reversed_sets)
    print(f"{case}: destinations with a tie broken differently: {ties}")
    assert sum(ties.values()) <= max_ties
    if case == "sort_by_source":  # stable sorts: the order within a destination too
        for key, es in g_jax.edges.items():
            np.testing.assert_array_equal(g_port[key].edge_index, es.edge_index)
    if case == "remove_unconnected":
        kept = g_port["hidden"].attributes["kept"]
        assert g_port["hidden"].num_nodes < 642 and kept.shape == (g_port["hidden"].num_nodes, 1)


def test_mesh_builders_refuse_wrong_node_counts(files):
    """Where the JAX package asserts, the port raises ValueError."""
    g = Graph()
    g["m"] = NodeSet(np.zeros((100, 2)))
    g["cells"] = NodeSet(nodes.build_nodes({"name": "ICONCellGridNodes",
                                            "grid_filename": files["icon3"]}))
    cases = [
        (edges.multi_scale_edges, dict(mesh_type="tri"), "MultiScaleEdges"),
        (edges.multi_scale_edges, dict(), "Cannot infer"),
        (edges.multi_scale_edges, dict(mesh_type="hex", resolution=1), "hex mesh"),
        (edges.healpix_multi_scale_edges, dict(), "HEALPix resolution"),
        (edges.icon_processor_edges, dict(grid_filename=files["icon3"], max_level=2),
         "ICONMultiMeshNodes"),
    ]
    for fn, kw, match in cases:
        with pytest.raises(ValueError, match=match):
            fn(g, "m", "m", **kw)
    with pytest.raises(ValueError, match="ICON multimesh"):
        edges.icon_encoder_edges(g, "cells", "m", files["icon3"], 2)
    with pytest.raises(ValueError, match="depth_children"):
        g["t"] = NodeSet(nodes.tri_nodes(1))
        edges.multi_scale_edges(g, "t", "t", depth_children=1)
    with pytest.raises(ValueError, match="connect a node set to itself"):
        edges.multi_scale_edges(g, "t", "m")
    g["h"] = NodeSet(nodes.healpix_nodes(2))
    for scales, match in (([0, 1], "positive"), ([1, 3], "exceed")):
        with pytest.raises(ValueError, match=match):
            edges.healpix_multi_scale_edges(g, "h", "h", scale_resolutions=scales)
        with pytest.raises(AssertionError, match=match):
            jax_edges.healpix_multi_scale_edges(g, "h", "h", scale_resolutions=scales)


# --- ICON reading and hierarchy ---------------------------------------------------
def test_icon_contract_cells_nested_fallback_matches_jax():
    """Nested/LAM grids: cells without a complete ancestor triangle become
    [-1, -1, -1] in both packages."""
    parents = np.array([[0, 0], [1, 1], [2, 2], [0, 1], [4, 4]], dtype=np.int64)
    reflvl = np.array([0, 0, 0, 1, 1], dtype=np.int64)
    cells = np.array([[0, 3, 2], [0, 4, 2], [-1, -1, -1]], dtype=np.int64)
    ours = icon._contract_cells(cells, parents, reflvl, level=1)
    np.testing.assert_array_equal(ours, jax_icon._contract_cells(cells, parents, reflvl, 1))
    np.testing.assert_array_equal(ours, [[0, 1, 2], [-1, -1, -1], [-1, -1, -1]])


def test_icon_nested_grid_matches_jax(tmp_path):
    """A limited-area cut of a synthetic grid (the cells and vertices inside
    a cap, renumbered): the hierarchy keeps the cells with a full ancestor
    triangle, and both packages build the same multimesh and encoder."""
    full = str(tmp_path / "full.nc")
    icon.write_synthetic_icon_grid(full, 3)
    g = icon.load_icon_grid(full)
    keep_c = np.flatnonzero(g.clat > np.deg2rad(30.0))
    keep_v = np.unique(g.cell_vertices[keep_c])
    new_v = -np.ones(g.num_vertices, dtype=np.int64)
    new_v[keep_v] = np.arange(len(keep_v))
    cells = new_v[g.cell_vertices[keep_c]]
    ev = g.edge_vertices[np.isin(g.edge_vertices, keep_v).all(axis=1)]
    path = str(tmp_path / "lam.nc")
    with netcdf_file(path, "w") as nc:
        for dim, n in (("vertex", len(keep_v)), ("edge", len(ev)), ("cell", len(keep_c)),
                       ("nc", 2), ("nv", 3)):
            nc.createDimension(dim, n)
        for name, dims, data, dtype in (
                ("vlat", ("vertex",), g.vlat[keep_v], "d"),
                ("vlon", ("vertex",), g.vlon[keep_v], "d"),
                ("refinement_level_v", ("vertex",), g.reflvl_vertex[keep_v], "i"),
                ("clat", ("cell",), g.clat[keep_c], "d"),
                ("clon", ("cell",), g.clon[keep_c], "d"),
                ("refinement_level_c", ("cell",), g.reflvl_cell[keep_c], "i"),
                ("edge_vertices", ("nc", "edge"), (new_v[ev] + 1).T, "i"),
                ("vertex_of_cell", ("nv", "cell"), (cells + 1).T, "i")):
            nc.createVariable(name, dtype, dims)[:] = data
    mesh, ref = icon.icon_multimesh(path, 1), jax_icon.icon_multimesh(path, 1)
    np.testing.assert_array_equal(mesh.cell_vertices, ref.cell_vertices)
    assert (mesh.cell_vertices < 0).all(axis=1).any()  # the fallback ran
    assert (mesh.cell_vertices >= 0).all(axis=1).any()
    np.testing.assert_array_equal(mesh.multi_mesh_edges(), ref.multi_mesh_edges())
    np.testing.assert_array_equal(icon.icon_grid2mesh_edges(path, 1),
                                  jax_icon.icon_grid2mesh_edges(path, 1))


def test_icon_caches_keyed_by_mtime(tmp_path):
    """Regenerating a grid file at the same path invalidates the grid and
    the multimesh caches; cached arrays are read-only."""
    path = str(tmp_path / "icon.nc")
    icon.write_synthetic_icon_grid(path, 2)
    g1, m1 = icon.load_icon_grid(path), icon.icon_multimesh(path, 1)
    assert not g1.vlon.flags.writeable
    with pytest.raises(ValueError):
        g1.vlon[0] = 99.0
    assert icon.load_icon_grid(path) is g1 and icon.icon_multimesh(path, 1) is m1
    icon.write_synthetic_icon_grid(path, 3)
    os.utime(path, (os.path.getmtime(path) + 2, os.path.getmtime(path) + 2))
    g2, m2 = icon.load_icon_grid(path), icon.icon_multimesh(path, 1)
    assert g2.num_vertices > g1.num_vertices and g2.num_vertices == 642
    assert m2 is not m1 and m2.num_nodes == m1.num_nodes == 42
    assert len(m2.cell_vertices) == 1280


def test_icon_reader_refuses_netcdf4(tmp_path):
    path = str(tmp_path / "grid_nc4.nc")
    with open(path, "wb") as f:
        f.write(b"\x89HDF\r\n\x1a\n" + bytes(64))
    for load in (icon.load_icon_grid, jax_icon.load_icon_grid):
        with pytest.raises(OSError, match="nccopy -k classic"):
            load(path)
