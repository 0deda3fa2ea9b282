"""Recipe-driven graph assembly.

Copy of ``anemoi_tpu.graphs.create.GraphCreator`` for recipes given as Python
dicts (the port reads no YAML):

    {"nodes": {"data": {"node_builder": {"name": "ReducedGaussianGridNodes",
                                         "grid": "o96"},
                        "attributes": {...}},
               "hidden": {"node_builder": {"name": "TriNodes", "resolution": 5}}},
     "edges": [{"source_name": "data", "target_name": "hidden",
                "edge_builder": {"name": "CutOffEdges", "cutoff_factor": 0.6},
                "attributes": {"edge_length": {"name": "EdgeLength"}}}, ...],
     "post_processors": [{"name": "SortNodesBySpaceFillingCurve",
                          "nodes_name": "hidden"}]}

Edges are always dst-sorted at the end, even if the recipe omits the
post-processor.
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

from anemoi_tpu_torch.graphs.edges import build_edge_attribute, build_edges
from anemoi_tpu_torch.graphs.graph import EdgeSet, Graph, NodeSet
from anemoi_tpu_torch.graphs.nodes import build_node_attribute, build_nodes
from anemoi_tpu_torch.graphs.post_process import apply_post_processor, sort_edges_by_dst


class GraphCreator:
    """Build a heterogeneous graph from a recipe dict."""

    def __init__(self, config: Dict) -> None:
        self.config = config

    def update_graph(self, graph: Graph) -> Graph:
        for nodes_name, node_cfg in self.config.get("nodes", {}).items():
            coords = build_nodes(node_cfg["node_builder"], graph=graph)
            graph[nodes_name] = NodeSet(coords=np.asarray(coords, dtype=np.float64))
            for attr_name, attr_cfg in (node_cfg.get("attributes") or {}).items():
                graph[nodes_name].attributes[attr_name] = build_node_attribute(
                    graph, nodes_name, attr_cfg
                )

        for edge_cfg in self.config.get("edges", []):
            src = edge_cfg["source_name"]
            dst = edge_cfg["target_name"]
            builder_cfg = dict(edge_cfg["edge_builder"])
            builder_cfg.setdefault("source_name", src)
            builder_cfg.setdefault("target_name", dst)
            edge_index = build_edges(graph, builder_cfg)
            es = EdgeSet(edge_index=edge_index)
            for attr_name, attr_cfg in (edge_cfg.get("attributes") or {}).items():
                es.attributes[attr_name] = build_edge_attribute(
                    graph, src, dst, edge_index, attr_cfg
                )
            graph[(src, dst)] = es
        return graph

    def post_process(self, graph: Graph) -> Graph:
        for proc_cfg in self.config.get("post_processors", []):
            graph = apply_post_processor(graph, proc_cfg)
        return sort_edges_by_dst(graph)

    def create(self, save_path: Optional[str] = None, overwrite: bool = False) -> Graph:
        """Build the graph; with ``save_path``, load it from there when the
        file exists (unless ``overwrite``), else write it there."""
        if save_path and os.path.exists(save_path) and not overwrite:
            return Graph.load(save_path)
        graph = self.post_process(self.update_graph(Graph()))
        if save_path:
            graph.save(save_path)
        return graph


def describe(graph: Graph) -> str:
    """A human-readable summary: node sets, edge sets and their attributes."""
    lines = ["Graph summary", "============="]
    for name, ns in graph.nodes.items():
        lines.append(f"nodes '{name}': {ns.num_nodes} nodes")
        for attr, v in ns.attributes.items():
            lines.append(f"    attr '{attr}': shape {tuple(v.shape)} dtype {v.dtype}")
    for (src, dst), es in graph.edges.items():
        deg = es.num_edges / max(graph[dst].num_nodes, 1)
        lines.append(
            f"edges '{src}'->'{dst}': {es.num_edges} edges "
            f"(mean in-degree {deg:.1f}, dst_sorted={es.is_dst_sorted})"
        )
        for attr, v in es.attributes.items():
            lines.append(f"    attr '{attr}': shape {tuple(v.shape)} dtype {v.dtype}")
    return "\n".join(lines)
