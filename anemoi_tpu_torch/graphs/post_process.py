"""Graph post-processors.

Copy of ``anemoi_tpu.graphs.post_process``: the destination sort (the CSR
invariant), the source sort, the two node relabelings and the two node
subsets (unconnected nodes, a lat/lon box), in the table ``POST_PROCESSORS``.
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


def sort_edges_by_src(graph: Graph) -> Graph:
    """Stably sort every edge set by source node.  The recipe ends with the
    destination sort all the same (the CSR invariant)."""
    for key in list(graph.edges):
        es = graph.edges[key]
        order = np.argsort(es.edge_index[0], kind="stable")
        graph.edges[key] = EdgeSet(edge_index=es.edge_index[:, order],
                                   attributes={k: v[order] for k, v in es.attributes.items()})
    return graph


def _keep_nodes(graph: Graph, nodes_name: str, keep_idx: np.ndarray,
                extra_attributes: Optional[dict] = None) -> Graph:
    """Keep the nodes ``keep_idx`` of ``nodes_name`` (in that order) and the
    edges of every touching set whose endpoints are both kept."""
    ns = graph[nodes_name]
    relabel = -np.ones(ns.num_nodes, dtype=np.int64)
    relabel[keep_idx] = np.arange(len(keep_idx))
    graph.nodes[nodes_name] = NodeSet(
        coords=ns.coords[keep_idx],
        attributes={**{k: v[keep_idx] for k, v in ns.attributes.items()},
                    **(extra_attributes or {})},
    )
    for key in list(graph.edges):
        src, dst = key
        if src != nodes_name and dst != nodes_name:
            continue
        es = graph.edges[key]
        ei = es.edge_index.copy()
        mask = np.ones(es.num_edges, dtype=bool)
        if src == nodes_name:
            ei[0] = relabel[ei[0]]
            mask &= ei[0] >= 0
        if dst == nodes_name:
            ei[1] = relabel[ei[1]]
            mask &= ei[1] >= 0
        graph.edges[key] = EdgeSet(edge_index=ei[:, mask],
                                   attributes={k: v[mask] for k, v in es.attributes.items()})
    return graph


def remove_unconnected_nodes(
    graph: Graph,
    nodes_name: str,
    ignore: Optional[str] = None,
    save_mask_indices_to_attr: Optional[str] = None,
) -> Graph:
    """Drop the nodes of ``nodes_name`` that no edge touches.  ``ignore``
    names a boolean attribute whose True nodes stay regardless;
    ``save_mask_indices_to_attr`` stores the kept nodes' old indices."""
    ns = graph[nodes_name]
    connected = np.zeros(ns.num_nodes, dtype=bool)
    for (src, dst), es in graph.edges.items():
        if src == nodes_name:
            connected[es.edge_index[0]] = True
        if dst == nodes_name:
            connected[es.edge_index[1]] = True
    if ignore is not None:
        connected |= ns.attributes[ignore].reshape(-1).astype(bool)
    keep_idx = np.flatnonzero(connected)
    extra = {save_mask_indices_to_attr: keep_idx[:, None]} if save_mask_indices_to_attr else None
    return _keep_nodes(graph, nodes_name, keep_idx, extra)


def subset_nodes_in_area(
    graph: Graph,
    nodes_name: str,
    lat_min: float = -90.0,
    lat_max: float = 90.0,
    lon_min: float = -180.0,
    lon_max: float = 180.0,
) -> Graph:
    """Keep only the nodes inside a lat/lon box (degrees, bounds included)."""
    lat, lon = np.rad2deg(graph[nodes_name].coords).T
    keep = (lat >= lat_min) & (lat <= lat_max) & (lon >= lon_min) & (lon <= lon_max)
    return _keep_nodes(graph, nodes_name, np.flatnonzero(keep))


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
    "SortEdgeIndexBySourceNodes": sort_edges_by_src,
    "RemoveUnconnectedNodes": remove_unconnected_nodes,
    "SubsetNodesInArea": subset_nodes_in_area,
    "SortNodesBySpaceFillingCurve": sort_nodes_by_space_filling_curve,
    "SortNodesByIncomingDegree": sort_nodes_by_incoming_degree,
}


def apply_post_processor(graph: Graph, config: dict) -> Graph:
    fn, cfg = _lookup(POST_PROCESSORS, "graph post-processor", config)
    return fn(graph=graph, **cfg)
