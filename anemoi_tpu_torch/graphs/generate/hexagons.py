"""Hexagonal icosahedral mesh generation (pure numpy, no h3).

Copy of ``anemoi_tpu.graphs.generate.hexagons``.  anemoi-graphs covers the
sphere with H3 hexagon cells (`create_hex_nodes`, `add_edges_to_nx_graph`);
without h3, the hex mesh is built as the
**dual (Goldberg polyhedron) of the refined triangular icosphere**: one node
per triangle face (its normalised centroid), adjacency between faces sharing
an edge.  The resulting per-level graph is the spherical hexagonal honeycomb
(3-regular; the dual tiling's cells are hexagons plus exactly 12 pentagons
around the original icosahedron vertices) — a genuinely hexagonal-lattice
mesh, distinct from the 6-regular TriNodes vertex mesh.  Multi-scale
connectivity comes from unioning levels, exactly like the tri and HEALPix
meshes in this package; use ``x_hops`` for wider per-level neighbourhoods.

Refinement is aperture 4 (each face splits into 4 children) instead of H3's
aperture 7; the cross-scale embedding maps a coarse face to its centre child
(`4*f + 3`, see `icosahedron._subdivide` child ordering), mirroring how the
HEALPix nested mapping embeds coarse pixels (`healpix.py`).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import scipy.sparse as sp

from anemoi_tpu_torch.graphs.generate.icosahedron import khop_adjacency, tri_icosphere
from anemoi_tpu_torch.graphs.transforms import xyz_to_latlon_rad


def num_hex_nodes(resolution: int) -> int:
    """20 * 4^r faces of the level-r icosphere."""
    return 20 * 4**resolution


def _face_centroids(verts: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """Normalised centroids of each triangle face — the dual (hex) nodes."""
    c = verts[faces].mean(axis=1)
    return c / np.linalg.norm(c, axis=1, keepdims=True)


def face_adjacency_edges(faces: np.ndarray) -> np.ndarray:
    """Pairs of faces sharing an edge, as a [P, 2] array (each pair once).

    Vectorised: every face contributes its 3 (sorted) edges; faces appearing
    under the same edge key are adjacent.  On a closed manifold every edge is
    shared by exactly 2 faces.
    """
    f = faces.astype(np.int64)
    e = np.concatenate([f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]], axis=0)
    e.sort(axis=1)
    nv = int(f.max()) + 1
    keys = e[:, 0] * nv + e[:, 1]
    face_ids = np.tile(np.arange(len(f), dtype=np.int64), 3)
    order = np.argsort(keys, kind="stable")
    keys, face_ids = keys[order], face_ids[order]
    assert len(keys) % 2 == 0 and np.array_equal(keys[0::2], keys[1::2]), (
        "mesh is not a closed 2-manifold (some edge not shared by exactly 2 faces)"
    )
    return np.stack([face_ids[0::2], face_ids[1::2]], axis=1)


def _embed_to_finest(face_ids: np.ndarray, level: int, resolution: int) -> np.ndarray:
    """Map level-``level`` face ids to their centre descendant at ``resolution``.

    `_subdivide` orders children of face f as 4f..4f+3 with 4f+3 the centre
    triangle (midpoint-midpoint-midpoint), whose centroid best represents the
    parent cell.
    """
    out = face_ids.astype(np.int64)
    for _ in range(resolution - level):
        out = 4 * out + 3
    return out


def create_hex_nodes(resolution: int) -> np.ndarray:
    """(lat, lon) radians of the level-``resolution`` hex (dual) nodes.

    """
    verts, faces_per_level, _ = tri_icosphere(resolution)
    return xyz_to_latlon_rad(_face_centroids(verts, faces_per_level[-1]))


def hex_multi_scale_edge_index(
    resolution: int,
    scale_resolutions: Optional[List[int]] = None,
    x_hops: int = 1,
    depth_children: int = 0,
) -> np.ndarray:
    """Multi-scale edges over the level-``resolution`` hex node set.

    For each level in ``scale_resolutions`` (default 0..resolution), connect
    cells adjacent (within ``x_hops``) at that level, with coarse cells
    embedded at their centre descendant.  ``depth_children`` additionally
    connects each cell to its (embedded) descendants up to that many levels
    down, both directions — the analogue of anemoi-graphs'
    `add_edges_to_nx_graph(depth_children=...)` parent/child H3 edges.  Note depth 1 is a no-op when the finer
    level is already in ``scale_resolutions``: the centre-child embedding
    makes parent->child edges coincide with the finer level's adjacency
    (the centre triangle is face-adjacent to its 3 siblings); depth >= 2
    adds genuinely new cross-level shortcuts.

    Returns a deduplicated, bidirectional ``[2, E]`` edge index.
    """
    if scale_resolutions is None:
        scale_resolutions = list(range(resolution + 1))
    _, faces_per_level, _ = tri_icosphere(resolution)

    pairs: List[np.ndarray] = []
    for level in scale_resolutions:
        adj = face_adjacency_edges(faces_per_level[level])
        if x_hops > 1:
            n = len(faces_per_level[level])
            a = sp.coo_matrix(
                (np.ones(2 * len(adj), dtype=np.int8),
                 (np.concatenate([adj[:, 0], adj[:, 1]]),
                  np.concatenate([adj[:, 1], adj[:, 0]]))),
                shape=(n, n),
            ).tocsr()
            a = khop_adjacency(a, x_hops).tocoo()
            keep = a.row < a.col
            adj = np.stack([a.row[keep], a.col[keep]], axis=1).astype(np.int64)
        pairs.append(_embed_to_finest(adj, level, resolution))
        for depth in range(1, depth_children + 1):
            if level + depth > resolution:
                break
            parents = np.arange(len(faces_per_level[level]), dtype=np.int64)
            children = parents[:, None]
            for _ in range(depth):
                children = 4 * children[..., None] + np.arange(4, dtype=np.int64)
                children = children.reshape(len(parents), -1)
            p_fine = _embed_to_finest(parents, level, resolution)
            c_fine = _embed_to_finest(children.ravel(), level + depth, resolution)
            pc = np.stack([np.repeat(p_fine, children.shape[1]), c_fine], axis=1)
            pairs.append(pc[pc[:, 0] != pc[:, 1]])

    und = np.concatenate(pairs, axis=0)
    both = np.concatenate([und, und[:, ::-1]], axis=0)
    both = np.unique(both, axis=0)
    return both.T.astype(np.int64)
