"""Triangular icosphere generation (pure numpy).

Copy of ``anemoi_tpu.graphs.generate.icosahedron``: progressive midpoint
subdivision of the icosahedron where every coarser level's vertices are a
**prefix** of the finer level's vertex array, so multi-scale edges at any
level index directly into the finest node set.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import scipy.sparse as sp

from anemoi_tpu_torch.graphs.transforms import xyz_to_latlon_rad


def icosahedron() -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosahedron: 12 vertices [12,3], 20 faces [20,3]."""
    phi = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, phi, 0], [1, phi, 0], [-1, -phi, 0], [1, -phi, 0],
            [0, -1, phi], [0, 1, phi], [0, -1, -phi], [0, 1, -phi],
            [phi, 0, -1], [phi, 0, 1], [-phi, 0, -1], [-phi, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = np.array(
        [
            [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
            [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
            [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
            [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1],
        ],
        dtype=np.int64,
    )
    return verts, faces


def _subdivide(verts: np.ndarray, faces: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """One midpoint subdivision; existing vertex indices are preserved."""
    midpoint_cache: Dict[Tuple[int, int], int] = {}
    verts_list = [verts]
    next_idx = len(verts)
    new_rows: List[np.ndarray] = []

    def midpoint(a: int, b: int) -> int:
        nonlocal next_idx
        key = (a, b) if a < b else (b, a)
        idx = midpoint_cache.get(key)
        if idx is None:
            m = verts[a] + verts[b]
            m /= np.linalg.norm(m)
            new_rows.append(m)
            idx = next_idx
            midpoint_cache[key] = idx
            next_idx += 1
        return idx

    new_faces = np.empty((len(faces) * 4, 3), dtype=np.int64)
    for fi, (a, b, c) in enumerate(faces):
        ab = midpoint(int(a), int(b))
        bc = midpoint(int(b), int(c))
        ca = midpoint(int(c), int(a))
        new_faces[4 * fi + 0] = (a, ab, ca)
        new_faces[4 * fi + 1] = (b, bc, ab)
        new_faces[4 * fi + 2] = (c, ca, bc)
        new_faces[4 * fi + 3] = (ab, bc, ca)
    if new_rows:
        verts_list.append(np.stack(new_rows))
    return np.concatenate(verts_list, axis=0), new_faces


def tri_icosphere(resolution: int) -> Tuple[np.ndarray, List[np.ndarray], List[int]]:
    """Icosphere subdivided ``resolution`` times.

    Returns (vertices_xyz [V,3], faces_per_level list of [F_l,3], num_vertices_per_level).
    Level-l vertices are the first ``num_vertices_per_level[l]`` rows.
    """
    verts, faces = icosahedron()
    faces_per_level = [faces]
    nverts_per_level = [len(verts)]
    for _ in range(resolution):
        verts, faces = _subdivide(verts, faces)
        faces_per_level.append(faces)
        nverts_per_level.append(len(verts))
    return verts, faces_per_level, nverts_per_level


def num_tri_nodes(resolution: int) -> int:
    return 10 * 4**resolution + 2


def faces_to_adjacency(faces: np.ndarray, num_nodes: int) -> sp.csr_matrix:
    """Symmetric 0/1 adjacency from a triangle list."""
    src = np.concatenate([faces[:, 0], faces[:, 1], faces[:, 2]])
    dst = np.concatenate([faces[:, 1], faces[:, 2], faces[:, 0]])
    data = np.ones(len(src), dtype=np.int8)
    adj = sp.coo_matrix((data, (src, dst)), shape=(num_nodes, num_nodes)).tocsr()
    adj = adj + adj.T
    adj.data = np.ones_like(adj.data)
    return adj


def khop_adjacency(adj: sp.csr_matrix, x_hops: int) -> sp.csr_matrix:
    """Union of 1..x_hops neighbourhoods, diagonal removed."""
    result = adj.copy()
    power = adj.copy()
    for _ in range(x_hops - 1):
        power = power @ adj
        result = result + power
    result.setdiag(0)
    result.eliminate_zeros()
    result.data = np.ones_like(result.data)
    return result


def create_tri_nodes(resolution: int) -> np.ndarray:
    """(lat, lon) radians of the level-``resolution`` tri icosphere nodes."""
    verts, _, _ = tri_icosphere(resolution)
    return xyz_to_latlon_rad(verts)


def multi_scale_edge_index(
    resolution: int,
    scale_resolutions: List[int] | None = None,
    x_hops: int = 1,
) -> np.ndarray:
    """Multi-scale edges over the level-``resolution`` node set.

    For each level l in ``scale_resolutions`` (default: 0..resolution), connect
    nodes adjacent (within ``x_hops``) in the level-l mesh.  Because coarse
    vertices are prefixes, the same node ids apply at every scale; duplicate
    edges across scales are merged.
    """
    if scale_resolutions is None:
        scale_resolutions = list(range(resolution + 1))
    _, faces_per_level, nverts = tri_icosphere(resolution)
    total = nverts[-1]
    acc = sp.csr_matrix((total, total), dtype=np.int8)
    for level in scale_resolutions:
        adj = faces_to_adjacency(faces_per_level[level], total)
        if x_hops > 1:
            adj = khop_adjacency(adj, x_hops)
        acc = acc + adj
    acc = acc.tocoo()
    keep = acc.data > 0
    edge_index = np.stack([acc.row[keep], acc.col[keep]]).astype(np.int64)
    return edge_index
