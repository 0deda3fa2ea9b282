"""ICON grid topology (pure numpy + scipy NetCDF-3, no netCDF4).

Copy of ``anemoi_tpu.graphs.generate.icon``, the counterpart of
anemoi-graphs' ``ICONMultiMesh`` and ``ICONCellDataGrid``: reads an ICON grid file's vertex/cell
coordinates and topology and reconstructs the refinement hierarchy so that

- the **multimesh** is the union of vertex-vertex edge sets at every
  refinement level 0..max_level (the processor graph), and
- every (fine) cell knows the 3 multimesh vertices of its level-``max_level``
  ancestor triangle (the encoder/decoder bipartite topology).

ICON grid files store, per the ICON grid-file convention:
``vlon/vlat [vertex]`` and ``clon/clat [cell]`` in radians,
``refinement_level_v [vertex]`` / ``refinement_level_c [cell]`` (the level at
which a vertex/cell was introduced), ``edge_vertices [nc=2, edge]`` and
``vertex_of_cell [nv=3, cell]`` (1-based).

The hierarchy reconstruction differs from anemoi-graphs' sparse-matrix
formulation but computes the same thing: ICON refines by edge bisection, so a
vertex introduced at level ``l`` is the midpoint of exactly one parent edge,
and its only neighbours at levels ``< l`` are that edge's two endpoints.
Contracting every level-``l`` midpoint to its parent pair therefore recovers
the level-``l-1`` edge set (keep contracted edges with exactly 2 distinct
endpoints) and the level-``l-1`` ancestor triangle of every cell (each cell's
3 contracted vertices have exactly 3 distinct parents).

This module reads the classic NetCDF-3 format via ``scipy.io.netcdf_file``.
NetCDF-4/HDF5 ICON files must be converted first (``nccopy -k classic``);
the loader raises a clear error in that case.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class IconGrid:
    """Raw arrays of an ICON grid file (0-based indexing)."""

    vlon: np.ndarray  # [V] radians
    vlat: np.ndarray  # [V]
    reflvl_vertex: np.ndarray  # [V] int
    clon: np.ndarray  # [C] radians
    clat: np.ndarray  # [C]
    reflvl_cell: np.ndarray  # [C] int
    edge_vertices: np.ndarray  # [E, 2] int64, finest-level vertex-vertex edges
    cell_vertices: np.ndarray  # [C, 3] int64, vertices of each cell

    @property
    def num_vertices(self) -> int:
        return len(self.vlon)

    @property
    def max_refinement_level(self) -> int:
        return int(self.reflvl_vertex.max())


def load_icon_grid(grid_filename: str) -> IconGrid:
    """Read an ICON grid file.

    Cached on (path, mtime) so a regenerated file at the same path is
    re-read; cached arrays are marked read-only (shared across callers)."""
    import os

    path = os.path.abspath(grid_filename)
    return _load_icon_grid_cached(path, os.path.getmtime(path))


@lru_cache(maxsize=8)
def _load_icon_grid_cached(grid_filename: str, _mtime: float) -> IconGrid:
    from scipy.io import netcdf_file

    try:
        nc = netcdf_file(grid_filename, "r", mmap=False)
    except Exception as err:  # noqa: BLE001 - re-raise with actionable context
        raise OSError(
            f"Could not read '{grid_filename}' as classic NetCDF-3. ICON grid "
            "files in NetCDF-4/HDF5 format must be converted first "
            "(`nccopy -k classic in.nc out.nc`)."
        ) from err
    with nc:
        def arr(name, dtype=None):
            v = np.array(nc.variables[name][:])
            return v.astype(dtype) if dtype is not None else v

        grid = IconGrid(
            vlon=arr("vlon", np.float64),
            vlat=arr("vlat", np.float64),
            reflvl_vertex=arr("refinement_level_v", np.int64),
            clon=arr("clon", np.float64),
            clat=arr("clat", np.float64),
            reflvl_cell=arr("refinement_level_c", np.int64),
            edge_vertices=arr("edge_vertices", np.int64).T - 1,  # [nc=2,E] 1-based
            cell_vertices=arr("vertex_of_cell", np.int64).T - 1,  # [nv=3,C] 1-based
        )
    if grid.edge_vertices.shape[1] != 2 or grid.cell_vertices.shape[1] != 3:
        raise ValueError(f"'{grid_filename}': edge_vertices must be [2, E] and "
                         "vertex_of_cell [3, C]")
    for field in ("vlon", "vlat", "reflvl_vertex", "clon", "clat",
                  "reflvl_cell", "edge_vertices", "cell_vertices"):
        getattr(grid, field).flags.writeable = False
    return grid


def _midpoint_parents(edges: np.ndarray, reflvl: np.ndarray, level: int) -> np.ndarray:
    """[V, 2] parent map: level-``level`` midpoints -> their parent-edge
    endpoints (from the level-``level`` edge set); other vertices map to
    themselves in both slots."""
    num_v = len(reflvl)
    parents = np.tile(np.arange(num_v, dtype=np.int64)[:, None], (1, 2))
    u, w = edges[:, 0], edges[:, 1]
    # edges from a level-`level` midpoint to a strictly coarser endpoint
    half_u = (reflvl[u] == level) & (reflvl[w] < level)
    half_w = (reflvl[w] == level) & (reflvl[u] < level)
    mids = np.concatenate([u[half_u], w[half_w]])
    ends = np.concatenate([w[half_u], u[half_w]])
    order = np.argsort(mids, kind="stable")
    mids, ends = mids[order], ends[order]
    uniq, start, counts = np.unique(mids, return_index=True, return_counts=True)
    # Interior bisection midpoints have exactly 2 coarser neighbours; nest
    # boundary vertices may not — leave those on the identity map (edges
    # through them then contract to !=2 distinct endpoints and are dropped,
    # matching anemoi-graphs' exactly-2 selection).
    ok = counts == 2
    parents[uniq[ok], 0] = ends[start[ok]]
    parents[uniq[ok], 1] = ends[start[ok] + 1]
    return parents


def _contract_edges(edges: np.ndarray, parents: np.ndarray,
                    reflvl: np.ndarray, level: int) -> np.ndarray:
    """Level l edge set -> level l-1: contract midpoints, keep edges whose
    contracted endpoint set has exactly 2 distinct vertices — both strictly
    coarser than ``level`` (unmapped nest-boundary vertices must not leak
    into coarse levels) — and dedupe."""
    cand = np.stack(
        [parents[edges[:, 0], 0], parents[edges[:, 0], 1],
         parents[edges[:, 1], 0], parents[edges[:, 1], 1]],
        axis=1,
    )
    cand.sort(axis=1)
    distinct = 1 + (np.diff(cand, axis=1) != 0).sum(axis=1)
    keep = distinct == 2
    coarse = np.stack([cand[keep, 0], cand[keep, 3]], axis=1)  # min & max
    coarse = coarse[(reflvl[coarse] < level).all(axis=1)]
    return np.unique(coarse, axis=0)


def _contract_cells(
    cells: np.ndarray, parents: np.ndarray, reflvl: np.ndarray, level: int
) -> np.ndarray:
    """[C, 3] cell vertices -> the 3 vertices of each cell's parent triangle.

    Global-grid cells contract to exactly 3 distinct, strictly-coarser
    parents; incomplete boundary cells of LAM/nested ICON grids (unmapped
    nest-boundary midpoints stay on the identity map) do not and are marked
    [-1,-1,-1] (anemoi-graphs' csum==3 selection with -1 substitution);
    -1 rows propagate through further contractions."""
    valid_in = (cells >= 0).all(axis=1)
    safe = np.where(cells < 0, 0, cells)
    cand = np.concatenate([parents[safe[:, j]] for j in range(3)], axis=1)  # [C,6]
    cand.sort(axis=1)
    first = np.concatenate(
        [np.ones((len(cand), 1), dtype=bool), np.diff(cand, axis=1) != 0], axis=1
    )
    valid = (
        valid_in
        & (first.sum(axis=1) == 3)
        & (reflvl[cand] < level).all(axis=1)  # no fine vertex leaks coarse
    )
    out = np.full((len(cand), 3), -1, dtype=np.int64)
    if valid.any():
        sel = first[valid]
        out[valid] = cand[valid][sel].reshape(-1, 3)
    return out


class IconMultiMesh:
    """The processor multimesh: vertices with ``refinement_level_v <=
    max_level`` and the union of per-level edge sets.

    Attributes
    ----------
    coords : [V', 2] (lat, lon) radians of the selected vertices
    edge_levels : list of [E_l, 2] undirected edge arrays in LOCAL vertex ids,
        one per level 0..max_level
    cell_vertices : [C, 3] local multimesh-vertex ids of every (fine) cell's
        level-``max_level`` ancestor triangle — indexed by the FULL cell array
        so a cell grid's own selection can subscript it
    """

    def __init__(self, grid: IconGrid, max_level: Optional[int] = None) -> None:
        finest = grid.max_refinement_level
        self.max_level = finest if max_level is None else min(int(max_level), finest)

        edges_at: List[Optional[np.ndarray]] = [None] * (finest + 1)
        edges_at[finest] = np.unique(np.sort(grid.edge_vertices, axis=1), axis=0)
        cells = grid.cell_vertices
        for level in range(finest, 0, -1):
            parents = _midpoint_parents(edges_at[level], grid.reflvl_vertex, level)
            edges_at[level - 1] = _contract_edges(
                edges_at[level], parents, grid.reflvl_vertex, level
            )
            if level > self.max_level:
                cells = _contract_cells(cells, parents, grid.reflvl_vertex, level)

        select = grid.reflvl_vertex <= self.max_level
        glb2loc = np.full(grid.num_vertices, -1, dtype=np.int64)
        glb2loc[select] = np.arange(int(select.sum()), dtype=np.int64)
        self.coords = np.stack([grid.vlat[select], grid.vlon[select]], axis=-1)
        self.edge_levels = [glb2loc[edges_at[l]] for l in range(self.max_level + 1)]
        assert all((e >= 0).all() for e in self.edge_levels)
        # nested/LAM grids: boundary cells without a complete ancestor
        # triangle stay [-1,-1,-1] and are skipped by icon_grid2mesh_edges
        cell_valid = (cells >= 0).all(axis=1)
        self.cell_vertices = np.full_like(cells, -1)
        self.cell_vertices[cell_valid] = glb2loc[cells[cell_valid]]
        self.cell_vertices[(self.cell_vertices < 0).any(axis=1)] = -1
        if not (self.cell_vertices >= 0).any():
            raise ValueError("ICON hierarchy: no cell has a complete ancestor triangle at "
                             f"level {self.max_level}")

    @property
    def num_nodes(self) -> int:
        return len(self.coords)

    def multi_mesh_edges(self, bidirectional: bool = True) -> np.ndarray:
        """[2, E] union of all level edge sets."""
        und = np.concatenate(self.edge_levels, axis=0)
        if bidirectional:
            und = np.concatenate([und, und[:, ::-1]], axis=0)
        return np.unique(und, axis=0).T.astype(np.int64)


def icon_multimesh(grid_filename: str, max_level: Optional[int] = None) -> IconMultiMesh:
    """Cached on (path, mtime), like `load_icon_grid`."""
    import os

    path = os.path.abspath(grid_filename)
    return _icon_multimesh_cached(path, os.path.getmtime(path), max_level)


@lru_cache(maxsize=8)
def _icon_multimesh_cached(
    grid_filename: str, _mtime: float, max_level: Optional[int]
) -> IconMultiMesh:
    return IconMultiMesh(load_icon_grid(grid_filename), max_level)


def icon_cell_selection(grid: IconGrid, max_level: Optional[int] = None) -> np.ndarray:
    """Indices of cells with ``refinement_level_c <= max_level``."""
    lvl = int(grid.reflvl_cell.max()) if max_level is None else int(max_level)
    return np.flatnonzero(grid.reflvl_cell <= lvl)


def icon_grid2mesh_edges(
    grid_filename: str,
    max_level: Optional[int] = None,
    cell_max_level: Optional[int] = None,
) -> np.ndarray:
    """[E, 2] (cell, multimesh-vertex) pairs: each selected cell connects to
    the 3 vertices of its level-``max_level`` ancestor triangle."""
    grid = load_icon_grid(grid_filename)
    mesh = icon_multimesh(grid_filename, max_level)
    select_c = icon_cell_selection(grid, cell_max_level)
    src = np.repeat(np.arange(len(select_c), dtype=np.int64), 3)
    dst = mesh.cell_vertices[select_c].reshape(-1)
    keep = dst >= 0  # nested-grid boundary cells without an ancestor triangle
    return np.stack([src[keep], dst[keep]], axis=1)


def write_synthetic_icon_grid(path: str, resolution: int) -> None:
    """Write a small ICON-convention grid file (classic NetCDF-3) built from
    the refined icosahedron — vertices carry the level at which they first
    appear, cells are the finest faces (a global grid: refinement_level_c=0).

    Used by tests and by anyone without real ICON grid files.
    """
    from scipy.io import netcdf_file

    from anemoi_tpu_torch.graphs.generate.icosahedron import tri_icosphere
    from anemoi_tpu_torch.graphs.transforms import xyz_to_latlon_rad

    verts, faces_per_level, nverts = tri_icosphere(resolution)
    latlon = xyz_to_latlon_rad(verts)
    reflvl_v = np.zeros(len(verts), dtype=np.int32)
    for level in range(1, resolution + 1):
        reflvl_v[nverts[level - 1]: nverts[level]] = level
    faces = faces_per_level[-1]
    edges = np.unique(
        np.sort(
            np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]]),
            axis=1,
        ),
        axis=0,
    )
    centroids = verts[faces].mean(axis=1)
    centroids /= np.linalg.norm(centroids, axis=1, keepdims=True)
    c_latlon = xyz_to_latlon_rad(centroids)

    with netcdf_file(path, "w") as nc:
        nc.createDimension("vertex", len(verts))
        nc.createDimension("edge", len(edges))
        nc.createDimension("cell", len(faces))
        nc.createDimension("nc", 2)
        nc.createDimension("nv", 3)

        def var(name, dims, data, dtype):
            v = nc.createVariable(name, dtype, dims)
            v[:] = data
            if dtype == "d":
                v.units = "radian"

        var("vlat", ("vertex",), latlon[:, 0], "d")
        var("vlon", ("vertex",), latlon[:, 1], "d")
        var("refinement_level_v", ("vertex",), reflvl_v, "i")
        var("clat", ("cell",), c_latlon[:, 0], "d")
        var("clon", ("cell",), c_latlon[:, 1], "d")
        var("refinement_level_c", ("cell",), np.zeros(len(faces), np.int32), "i")
        var("edge_vertices", ("nc", "edge"), (edges + 1).T.astype(np.int32), "i")
        var("vertex_of_cell", ("nv", "cell"), (faces + 1).T.astype(np.int32), "i")
