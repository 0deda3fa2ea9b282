"""Model-side view of a Graph: device CSR tensors per sub-graph.

Port of ``anemoi_tpu.models.graph`` (``SubGraphArrays``, ``ModelGraph``,
``build_model_graph``).  The TPU's padded, bucketed, paged and slot tables
have no counterpart: the CUDA kernel reads the dst-sorted CSR directly.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional

import torch

from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.models.layers.embed import sincos_coordinates


@dataclass
class SubGraphArrays:
    """One directed sub-graph on the device."""

    edge_index: torch.Tensor  # [2, E] int32, dst-sorted (row 0 src, row 1 dst)
    dst_ptr: torch.Tensor  # [num_dst + 1] int32 CSR pointer
    edge_attr: torch.Tensor  # [E, F] in the model's compute type
    num_src: int
    num_dst: int

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    @property
    def edge_dim(self) -> int:
        return int(self.edge_attr.shape[1])


@dataclass
class ModelGraph:
    """Everything the model needs from the heterogeneous graph."""

    node_features: Dict[str, torch.Tensor]  # name -> [N, 4] sincos lat/lon
    num_nodes: Dict[str, int]
    encoder: Dict[str, SubGraphArrays]  # dataset name -> (data -> hidden)
    processor: SubGraphArrays  # hidden -> hidden
    decoder: Dict[str, SubGraphArrays]  # dataset name -> (hidden -> data)
    hidden_name: str = "hidden"


def extract_subgraph(
    graph: Graph, src: str, dst: str, edge_attributes: Optional[List[str]],
    device: torch.device, dtype: torch.dtype,
) -> SubGraphArrays:
    es = graph[(src, dst)]
    if not es.is_dst_sorted:
        raise ValueError(f"edges {src}->{dst} must be dst-sorted (run post-processing)")
    if es.num_edges >= 2**31:
        raise ValueError(f"edges {src}->{dst}: {es.num_edges} edges exceed int32 indexing")
    return SubGraphArrays(
        edge_index=torch.as_tensor(es.edge_index, dtype=torch.int32, device=device).contiguous(),
        dst_ptr=torch.as_tensor(es.dst_ptr, dtype=torch.int32, device=device),
        edge_attr=torch.as_tensor(es.attribute_matrix(edge_attributes), device=device).to(dtype),
        num_src=graph[src].num_nodes,
        num_dst=graph[dst].num_nodes,
    )


def build_model_graph(
    graph: Graph,
    dataset_names: List[str],
    device: torch.device,
    dtype: torch.dtype = torch.float32,
    hidden_name: str = "hidden",
    encoder_edge_attributes: Optional[List[str]] = None,
    processor_edge_attributes: Optional[List[str]] = None,
    decoder_edge_attributes: Optional[List[str]] = None,
) -> ModelGraph:
    """Edge attributes are concatenated in the order the config lists them
    (the bench uses ``[edge_dirs, edge_length]``; ``None`` means sorted names)."""
    if (hidden_name, hidden_name) not in graph.edges:
        raise NotImplementedError("graphs without processor edges are not ported")
    node_features = {
        name: torch.as_tensor(sincos_coordinates(graph[name].coords), device=device).to(dtype)
        for name in graph.node_names()
    }

    def sub(src, dst, attrs):
        return extract_subgraph(graph, src, dst, attrs, device, dtype)

    return ModelGraph(
        node_features=node_features,
        num_nodes={name: graph[name].num_nodes for name in graph.node_names()},
        encoder={ds: sub(ds, hidden_name, encoder_edge_attributes) for ds in dataset_names},
        processor=sub(hidden_name, hidden_name, processor_edge_attributes),
        decoder={ds: sub(hidden_name, ds, decoder_edge_attributes) for ds in dataset_names},
        hidden_name=hidden_name,
    )
