"""Graph post-processors.

Copy of ``anemoi_tpu.graphs.post_process``, trimmed to the destination sort
(the CSR invariant) and the two node relabelings the flagship recipe and the
frozen inference fixture use.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from anemoi_tpu_torch.graphs.graph import EdgeSet, Graph, NodeSet
from anemoi_tpu_torch.graphs.nodes import _lookup
from anemoi_tpu_torch.graphs.ordering import cube_morton_order


def sort_edges_by_dst(graph: Graph) -> Graph:
    """Stably sort every edge set by destination node and attach CSR dst_ptr."""
    for key in list(graph.edges):
        _, dst_name = key
        graph.edges[key] = graph.edges[key].sort_by_dst(graph[dst_name].num_nodes)
    return graph


def _relabel_nodes(graph: Graph, nodes_name: str, order: np.ndarray) -> Graph:
    """Permute a node set (and every touching edge set) so that new position
    ``i`` holds old node ``order[i]``.  Pure relabeling."""
    ns = graph[nodes_name]
    relabel = np.empty(ns.num_nodes, dtype=np.int64)
    relabel[order] = np.arange(ns.num_nodes)

    graph.nodes[nodes_name] = NodeSet(
        coords=ns.coords[order],
        attributes={k: v[order] for k, v in ns.attributes.items()},
    )
    for ekey in list(graph.edges):
        src, dst = ekey
        if src != nodes_name and dst != nodes_name:
            continue
        e = graph.edges[ekey]
        ei = e.edge_index.copy()
        if src == nodes_name:
            ei[0] = relabel[ei[0]]
        if dst == nodes_name:
            ei[1] = relabel[ei[1]]
        graph.edges[ekey] = EdgeSet(edge_index=ei, attributes=dict(e.attributes))
    return graph


def sort_nodes_by_space_filling_curve(graph: Graph, nodes_name: str) -> Graph:
    """Relabel ``nodes_name`` along a cube-sphere Morton curve.  Apply BEFORE
    the dst-sort post-processor."""
    coords = graph[nodes_name].coords
    order = cube_morton_order(np.rad2deg(coords[:, 0]), np.rad2deg(coords[:, 1]))
    return _relabel_nodes(graph, nodes_name, order)


def sort_nodes_by_incoming_degree(
    graph: Graph, nodes_name: str, edges_key: Optional[list] = None
) -> Graph:
    """Relabel ``nodes_name`` by DESCENDING in-degree of one of its edge sets
    (default: the self-edges).  Apply BEFORE the dst-sort post-processor."""
    key = tuple(edges_key) if edges_key else (nodes_name, nodes_name)
    deg = np.bincount(graph[key].edge_index[1], minlength=graph[nodes_name].num_nodes)
    order = np.argsort(-deg, kind="stable")  # old id per new position
    return _relabel_nodes(graph, nodes_name, order)


POST_PROCESSORS = {
    "SortEdgeIndexByDestinationNodes": sort_edges_by_dst,
    "SortNodesBySpaceFillingCurve": sort_nodes_by_space_filling_curve,
    "SortNodesByIncomingDegree": sort_nodes_by_incoming_degree,
}


def apply_post_processor(graph: Graph, config: dict) -> Graph:
    fn, cfg = _lookup(POST_PROCESSORS, "graph post-processor", config)
    return fn(graph=graph, **cfg)
