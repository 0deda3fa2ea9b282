"""Projection, truncation and smoother sub-graphs, and the fused-dataset
graph convention.

Port of ``anemoi_tpu.graphs.builders``: one-call construction of the KNN
projection, truncation (data <-> a coarser grid, both ways) and smoother
(self-loop KNN) sub-graphs that ``TruncatedConnection`` and projection
users read.  Edge weights are l1-normalised Gaussian distances under the
conventional attribute name ``gauss_weight``.  Like the JAX builders, the
sub-graphs come straight from ``GraphCreator.update_graph``: their edges are
in builder order (KNN: dst ascending), with no post-processing.
"""

from __future__ import annotations

from typing import List, Mapping, Set, Union

from anemoi_tpu_torch.graphs.create import GraphCreator
from anemoi_tpu_torch.graphs.graph import Graph, NodeSet

DEFAULT_DATASET_NAME = "data"
DEFAULT_EDGE_WEIGHT_ATTRIBUTE = "gauss_weight"
DEFAULT_GAUSSIAN_NORM = "l1"


def get_graph_node_names(graph_or_config: Union[Graph, Mapping]) -> Set[str]:
    """The node-set names of a built graph or of a graph recipe."""
    if isinstance(graph_or_config, Graph):
        return set(graph_or_config.nodes)
    nodes = graph_or_config.get("nodes", {}) if graph_or_config else {}
    return set(nodes.keys()) if nodes else set()


def uses_fused_dataset_graph(graph_or_config: Union[Graph, Mapping],
                             dataset_names: List[str]) -> bool:
    """Whether the graph has one node set per dataset instead of a single
    generic ``data`` set."""
    if not dataset_names:
        return False
    node_names = get_graph_node_names(graph_or_config)
    if not set(dataset_names).issubset(node_names):
        return False
    return dataset_names != [DEFAULT_DATASET_NAME] or DEFAULT_DATASET_NAME not in node_names


def _knn_edge_cfg(src: str, dst: str, k: int, sigma: float) -> dict:
    return {
        "source_name": src,
        "target_name": dst,
        "edge_builder": {"name": "KNNEdges", "num_nearest_neighbours": int(k)},
        "attributes": {DEFAULT_EDGE_WEIGHT_ATTRIBUTE: {
            "name": "GaussianDistanceWeights", "sigma": float(sigma),
            "norm": DEFAULT_GAUSSIAN_NORM}},
    }


def _target_nodes_cfg(config: Mapping) -> dict:
    node_builder = config.get("node_builder")
    if node_builder is None:
        grid = config.get("grid") or config.get("truncation_grid")
        if grid is None:
            raise ValueError("config must specify 'node_builder' or 'grid'")
        node_builder = {"name": "ReducedGaussianGridNodes", "grid": grid}
    return dict(node_builder)


def _with_nodes(graph: Graph, *names: str) -> Graph:
    sub = Graph()
    for name in names:
        sub[name] = NodeSet(coords=graph[name].coords)
    return sub


def build_node_to_node_projection_subgraph(graph: Graph, source_node_name: str,
                                           target_node_name: str, config: Mapping) -> Graph:
    """KNN projection sub-graph from source to target nodes with Gaussian
    edge weights.  The target's coordinates come from ``graph`` when it has
    them, else from ``config['node_builder']`` / ``config['grid']``;
    ``num_nearest_neighbours`` and ``sigma`` are required."""
    missing = [k for k in ("num_nearest_neighbours", "sigma") if config.get(k) is None]
    if missing:
        raise ValueError(f"build_node_to_node_projection_subgraph requires config keys {missing}")
    sub = _with_nodes(graph, source_node_name)
    recipe = {"nodes": {}, "edges": [_knn_edge_cfg(
        source_node_name, target_node_name, config["num_nearest_neighbours"], config["sigma"])]}
    if target_node_name == source_node_name:
        pass  # self-loop
    elif target_node_name in graph.nodes:
        sub[target_node_name] = NodeSet(coords=graph[target_node_name].coords)
    else:
        recipe["nodes"][target_node_name] = {"node_builder": _target_nodes_cfg(config)}
    return GraphCreator(recipe).update_graph(sub)


def build_truncation_subgraph(graph: Graph, data_node_name: str,
                              truncation_config: Mapping) -> Graph:
    """The data nodes and a coarser ``truncation`` grid with KNN edges both
    ways: the down and up projections of ``TruncatedConnection``."""
    k = int(truncation_config.get("num_nearest_neighbours", 3))
    sigma = float(truncation_config.get("sigma", 1.0))
    recipe = {
        "nodes": {"truncation": {"node_builder": _target_nodes_cfg(truncation_config)}},
        "edges": [_knn_edge_cfg(data_node_name, "truncation", k, sigma),
                  _knn_edge_cfg("truncation", data_node_name, k, sigma)],
    }
    return GraphCreator(recipe).update_graph(_with_nodes(graph, data_node_name))


def build_smoother_subgraph(graph: Graph, data_node_name: str,
                            smoother_config: Mapping) -> Graph:
    """Self-loop KNN smoother edges over the data nodes."""
    recipe = {"nodes": {}, "edges": [_knn_edge_cfg(
        data_node_name, data_node_name, smoother_config["num_nearest_neighbours"],
        smoother_config["sigma"])]}
    return GraphCreator(recipe).update_graph(_with_nodes(graph, data_node_name))
