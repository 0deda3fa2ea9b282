"""Model-side view of a Graph: device CSR tensors per sub-graph.

Port of ``anemoi_tpu.models.graph`` (``SubGraphArrays``, ``ModelGraph``,
``build_model_graph``).  The TPU's padded, bucketed, paged and slot tables
have no counterpart: the CUDA kernels read the dst-sorted CSR directly, and
the backward's source passes read a source-ordered view of it (``src_ptr``,
``src_perm``), the GPU counterpart of the TPU's page-sorted ``visit_slot`` /
``visit_page`` walk.

A graph without processor edges (``graph/encoder_decoder_only.yaml``, for
autoencoders and point-wise processors) gets an empty processor sub-graph,
as in the JAX package: no edges, ``dst_ptr`` of zeros, ``len(
processor_edge_attributes) or 1`` attribute columns.

The hierarchical V-cycle (``hidden_names``: its levels, finest first) also
reads, from the JAX ``AnemoiModelEncProcDecHierarchical.build_graph_inputs``:
``level[h]`` (``h -> h``, the processor's attributes) for every level that
has such edges, ``down[h_i]`` (``h_i -> h_{i+1}``, the encoder's attributes)
and ``up[h_{i+1}]`` (``h_{i+1} -> h_i``, the decoder's attributes);
``hidden_name`` is the finest level, the one the encoder and decoder map to.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch

from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.models.layers.embed import sincos_coordinates
from anemoi_tpu_torch.ops.gt_attention import SourceOrder


@dataclass
class SubGraphArrays:
    """One directed sub-graph on the device."""

    edge_index: torch.Tensor  # [2, E] int32, dst-sorted (row 0 src, row 1 dst)
    dst_ptr: torch.Tensor  # [num_dst + 1] int32 CSR pointer
    edge_attr: torch.Tensor  # [E, F] in the model's compute type
    num_src: int
    num_dst: int
    # the source-ordered view, built from edge_index when not given
    src_ptr: Optional[torch.Tensor] = None  # [num_src + 1] int32 pointer into src_perm
    src_perm: Optional[torch.Tensor] = None  # [E] int32 edge ids by source, stable by destination
    # the attention backward on this edge set: K3 + K4 (False) or K3 without
    # its per-edge buffer + K5 (True); set by the model from its config
    fused_bwd: bool = False

    def __post_init__(self) -> None:
        if self.src_ptr is None or self.src_perm is None:
            order = SourceOrder.of(self.edge_index, self.num_src)
            self.src_ptr, self.src_perm = order.src_ptr, order.src_perm

    @property
    def num_edges(self) -> int:
        return int(self.edge_index.shape[1])

    @property
    def edge_dim(self) -> int:
        return int(self.edge_attr.shape[1])

    @property
    def source(self) -> SourceOrder:
        return SourceOrder(self.src_ptr, self.src_perm)


@dataclass
class ModelGraph:
    """Everything the model needs from the heterogeneous graph."""

    node_features: Dict[str, torch.Tensor]  # name -> [N, 4] sincos lat/lon
    num_nodes: Dict[str, int]
    encoder: Dict[str, SubGraphArrays]  # dataset name -> (data -> hidden)
    processor: SubGraphArrays  # hidden -> hidden
    decoder: Dict[str, SubGraphArrays]  # dataset name -> (hidden -> data)
    hidden_name: str = "hidden"
    # the hierarchical levels, finest first, and their sub-graphs
    hidden_names: List[str] = field(default_factory=list)
    level: Dict[str, SubGraphArrays] = field(default_factory=dict)  # h -> (h -> h)
    down: Dict[str, SubGraphArrays] = field(default_factory=dict)  # h_i -> (h_i -> h_i+1)
    up: Dict[str, SubGraphArrays] = field(default_factory=dict)  # h_i+1 -> (h_i+1 -> h_i)
    # the host graph (the truncated residual's projections) and every node
    # set's sincos features in float32 whatever the compute type (the
    # dynamic edge providers' coordinates)
    source_graph: Optional[Graph] = None
    node_features_f32: Dict[str, torch.Tensor] = field(default_factory=dict)


def infer_hidden_names(node_names: Sequence[str]) -> List[str]:
    """The hierarchy's levels from a graph's ``hidden*`` node sets, sorted by
    the number after ``_`` (a bare ``hidden`` counts as 1), as the JAX
    ``AnemoiModelEncProcDecHierarchical.hidden_names`` infers them."""
    return sorted((n for n in node_names if n.startswith("hidden")),
                  key=lambda s: int(s.split("_")[1]) if "_" in s else 1)


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
    hidden_names: Optional[List[str]] = None,
) -> ModelGraph:
    """Edge attributes are concatenated in the order the config lists them
    (the bench uses ``[edge_dirs, edge_length]``; ``None`` means sorted names).
    With ``hidden_names`` (a hierarchy, finest level first, which must be
    ``hidden_name``), the V-cycle's level, down and up sub-graphs too."""
    node_features_f32 = {
        name: torch.as_tensor(sincos_coordinates(graph[name].coords), device=device).float()
        for name in graph.node_names()
    }
    node_features = {name: feat.to(dtype) for name, feat in node_features_f32.items()}

    def sub(src, dst, attrs):
        return extract_subgraph(graph, src, dst, attrs, device, dtype)

    if (hidden_name, hidden_name) in graph.edges:
        processor = sub(hidden_name, hidden_name, processor_edge_attributes)
    else:
        n_hidden = graph[hidden_name].num_nodes
        processor = SubGraphArrays(
            edge_index=torch.zeros((2, 0), dtype=torch.int32, device=device),
            dst_ptr=torch.zeros(n_hidden + 1, dtype=torch.int32, device=device),
            edge_attr=torch.zeros((0, len(processor_edge_attributes or []) or 1), device=device,
                                  dtype=dtype),
            num_src=n_hidden, num_dst=n_hidden,
        )

    levels = list(hidden_names or [])
    if levels and levels[0] != hidden_name:
        raise ValueError(f"the finest level {levels[0]} must be the hidden node set "
                         f"{hidden_name}")
    level, down, up = {}, {}, {}
    for h, nxt in zip(levels, levels[1:] + [None]):
        if (h, h) in graph.edges:
            # the finest level's set is the processor's: the same edges and attributes
            level[h] = processor if h == hidden_name else sub(h, h, processor_edge_attributes)
        if nxt is not None:
            down[h] = sub(h, nxt, encoder_edge_attributes)
            up[nxt] = sub(nxt, h, decoder_edge_attributes)
    return ModelGraph(
        node_features=node_features,
        num_nodes={name: graph[name].num_nodes for name in graph.node_names()},
        encoder={ds: sub(ds, hidden_name, encoder_edge_attributes) for ds in dataset_names},
        processor=processor,
        decoder={ds: sub(hidden_name, ds, decoder_edge_attributes) for ds in dataset_names},
        hidden_name=hidden_name,
        hidden_names=levels,
        level=level,
        down=down,
        up=up,
        source_graph=graph,
        node_features_f32=node_features_f32,
    )
