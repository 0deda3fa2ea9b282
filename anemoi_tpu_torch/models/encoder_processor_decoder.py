"""Encoder-processor-decoder graph model.

Port of ``anemoi_tpu.models.encoder_processor_decoder``:
``AnemoiModelEncProcDec``, ``AnemoiModelAutoEncoder`` and the ensemble model
``AnemoiEnsModelEncProcDec``.  Data flow, per
dataset: [B,T,E,G,V] -> [(B E), G, (T V)] (member-major rows: row ``b * E +
e`` is member ``e`` of sample ``b``), node attributes appended (and, for the
ensemble model, the forecast-step channel ``min(1, fcstep)``) -> encoder
(data -> hidden) -> sum of the latents -> noise hook (the ensemble's noise
injector; the conditioning it returns goes to every processor block) ->
processor over the hidden mesh -> latent skip -> decoder (hidden -> data) ->
[B,T,E,G,V] -> residual added on the prognostic variables -> boundings.

Components, by the config's ``name`` (the JAX ``ENCODERS``, ``PROCESSORS``
and ``DECODERS``, :data:`COMPONENTS`): the GraphTransformer, GNN,
point-wise and dense cross-attention Transformer mappers; the
``GraphTransformerProcessor``, ``GNNProcessor``, ``PointWiseMLPProcessor``
and the dense ``TransformerProcessor`` (sliding-window attention over the
hidden nodes in their order).  The point-wise and dense processors read no
processor edges: their edge set stays in the graph, unread, or is empty on
a graph without processor edges.

A mapper's ``edge_provider`` named ``DynamicKNN`` (``num_nearest_neighbours``
k, default 3; ``attributes``, default ``[edge_dirs, edge_length]``;
``max_out_degree``, the JAX package's transpose-table width, read and
unused: the port's source order is exact) replaces its static edge set, in
this model and its ensemble and autoencoder subclasses, by the kNN set of
its node sets' coordinates, built on the device every forward
(``ops/dynamic.py``; JAX ``_dynamic_edge_data``).  Any other provider is
dropped, as the JAX package drops it.
Model parallelism (:func:`shard_strategy`, JAX ``shard_strategy``): with
``num_model_shards`` S > 1 every node set -- the data grid, the hidden mesh
-- is split in contiguous row blocks over the model group
(``parallel/partition.py``) and each rank holds its rows.  Each component
takes its route (:func:`mapper_shard`, :func:`processor_shard`), whatever
the strategy's name (``edges``; ``gspmd``, ``none`` with S > 1 and
``shard_over_mesh``, which the JAX package runs by GSPMD sharding
constraints, take the same routes here; ``halo_mappers: false`` too):

- GraphTransformer and GNN mappers and processors: the halo
  (``parallel/halo.py``): the rank's CSR over ``[local | halo]`` sources
  after one exchange of the rows it reads (for the GraphTransformer keys
  and values, ``halo_overlap``, default on, splitting interior and boundary
  rows; for the GNN the source rows of each block);
- the Transformer processor: the band halo (``parallel/band.py``), the
  window's rows around the rank's block;
- the point-wise processor and mappers: the rank's rows alone;
- the dense cross-attention mappers and a ``DynamicKNN`` mapper: the
  rank's destinations over the whole source set (``parallel/rows.py``,
  the runtime set built for the rank's destinations);
- a processor whose ``shard_strategy`` (its own, else the model's) is
  ``heads`` -- GraphTransformer or Transformer -- takes the rank's block of
  hidden rows as its sequence shard (``parallel/heads.py``: one all-to-all
  to the whole mesh for the rank's heads before each attention, one back
  after it); a processor with no heads to split keeps its route above.

A residual that mixes grid rows (``TruncatedConnection``,
``SpectralOrnsteinConnection``) runs on the whole grid, gathered from the
ranks, and keeps the rank's rows.  :meth:`AnemoiModelEncProcDec.shard_over`
builds the tables once, from the interface's mesh; ``forward`` then takes
and returns the rank's grid rows.  The
``graph_attention_backend`` values of the JAX package (paged, padded,
segment) all select the port's one CSR attention and the GNN's one
``index_add_`` sum.  The attention's backward on each edge set follows the
JAX package's choice between the two-pass and the fused backward
(:func:`fused_backward`).
"""

from __future__ import annotations

import logging
from typing import Dict, Optional

import torch
from torch import nn

from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.models.graph import ModelGraph, SubGraphArrays
from anemoi_tpu_torch.models.layers.bounding import build_boundings
from anemoi_tpu_torch.models.layers.embed import NamedNodesAttributes
from anemoi_tpu_torch.models.layers.ensemble import build_noise_injector
from anemoi_tpu_torch.models.layers.mapper import (
    GNNBackwardMapper,
    GNNForwardMapper,
    GraphTransformerBackwardMapper,
    GraphTransformerForwardMapper,
    PointWiseBackwardMapper,
    PointWiseForwardMapper,
    TrainableEdgeFeatures,
    TransformerBackwardMapper,
    TransformerForwardMapper,
)
from anemoi_tpu_torch.models.layers.processor import (
    GNNProcessor,
    GraphTransformerProcessor,
    PointWiseMLPProcessor,
    TransformerProcessor,
)
from anemoi_tpu_torch.models.layers.residual import build_residual
from anemoi_tpu_torch.ops.dynamic import (
    ATTRIBUTE_WIDTHS,
    runtime_edge_attributes,
    runtime_knn,
)
from anemoi_tpu_torch.parallel.band import BandShard
from anemoi_tpu_torch.parallel.heads import HeadsShard
from anemoi_tpu_torch.parallel.rows import BlockShard, gather_blocks
from anemoi_tpu_torch.utils.tracing import components, plain

LOGGER = logging.getLogger(__name__)
BACKENDS = ("paged", "padded", "segment")
_DEFAULT_NAMES = {
    "encoder": "GraphTransformerForwardMapper",
    "processor": "GraphTransformerProcessor",
    "decoder": "GraphTransformerBackwardMapper",
}
_REMAT = ("gradient_checkpointing", "remat_policy")
_GT = ("num_heads", "mlp_hidden_ratio", "attn_channels", "qk_norm", "edge_pre_mlp",
       "mlp_implementation", *_REMAT)
# component name -> (part, the port's class, the config keys it takes, the
# other fields of the JAX module: set by the model, or steering only the
# TPU's execution)
COMPONENTS = {
    "GraphTransformerForwardMapper": (
        "encoder", GraphTransformerForwardMapper, _GT, ("hidden_dim", "edge_trainable_size",
                                                        "backend")),
    "GraphTransformerBackwardMapper": (
        "decoder", GraphTransformerBackwardMapper, _GT,
        ("hidden_dim", "out_channels_dst", "edge_trainable_size", "backend",
         "initialise_data_extractor_zero")),
    "GNNForwardMapper": (
        "encoder", GNNForwardMapper, ("mlp_extra_layers", "mlp_implementation"),
        ("hidden_dim", "edge_trainable_size", "backend")),
    "GNNBackwardMapper": (
        "decoder", GNNBackwardMapper, ("mlp_extra_layers", "mlp_implementation"),
        ("hidden_dim", "out_channels_dst", "edge_trainable_size", "backend",
         "initialise_data_extractor_zero")),
    "PointWiseForwardMapper": (
        "encoder", PointWiseForwardMapper, ("mlp_hidden_ratio",),
        ("hidden_dim", "edge_trainable_size", "backend")),
    "PointWiseBackwardMapper": (
        "decoder", PointWiseBackwardMapper, ("mlp_hidden_ratio",),
        ("hidden_dim", "out_channels_dst", "edge_trainable_size", "backend",
         "initialise_data_extractor_zero")),
    "TransformerForwardMapper": (
        "encoder", TransformerForwardMapper, ("num_heads", "mlp_hidden_ratio"),
        ("hidden_dim", "edge_trainable_size", "backend")),
    "TransformerBackwardMapper": (
        "decoder", TransformerBackwardMapper, ("num_heads", "mlp_hidden_ratio"),
        ("hidden_dim", "out_channels_dst", "edge_trainable_size", "backend",
         "initialise_data_extractor_zero")),
    "GraphTransformerProcessor": (
        "processor", GraphTransformerProcessor, ("num_layers", *_GT, "scan_unroll"),
        ("num_channels", "edge_trainable_size", "conditional", "scan_layers", "backend",
         "shard_strategy")),
    "TransformerProcessor": (
        "processor", TransformerProcessor,
        ("num_layers", "num_heads", "mlp_hidden_ratio", "attn_channels", "qk_norm",
         "window_size", "softcap", "use_alibi_slopes", "use_rotary_embeddings",
         "attention_impl", "mlp_implementation", *_REMAT),
        ("num_channels", "conditional", "scan_layers", "shard_strategy")),
    "GNNProcessor": (
        "processor", GNNProcessor,
        ("num_layers", "mlp_extra_layers", "mlp_hidden_ratio", "mlp_implementation", *_REMAT),
        ("num_channels", "edge_trainable_size", "scan_layers", "backend")),
    "PointWiseMLPProcessor": (
        "processor", PointWiseMLPProcessor, ("num_layers", "mlp_hidden_ratio", "activation"),
        ("num_channels", "gradient_checkpointing")),
}
# components that run over their sub-graph's edges (and so may carry
# trainable edge features on a graph provider)
EDGE_COMPONENTS = ("GraphTransformerForwardMapper", "GraphTransformerBackwardMapper",
                   "GNNForwardMapper", "GNNBackwardMapper", "GraphTransformerProcessor",
                   "GNNProcessor")


def _component(config: dict, part: str):
    """``(name, class, constructor kwargs)`` of one component by its config's
    ``name`` (the JAX package's ``ENCODERS``, ``PROCESSORS`` and
    ``DECODERS``).  As the JAX ``_field_filter`` does, keys that are no
    field of the chosen JAX module (left behind by preset composition) are
    dropped with a warning; fields that only steer the TPU's execution (scan,
    backend) and the edge provider (read by the model, :func:`dynamic_knn`)
    are dropped silently (the model applies ``shard_strategy``).  The
    processors' ``conditional`` is applied by the model (the conditioning's
    width); the GT processor's ``scan_unroll`` is checked against its depth,
    as the JAX processor checks it."""
    cfg = dict(config.get(part) or {})
    name = str(cfg.pop("name", _DEFAULT_NAMES[part]))
    if name not in COMPONENTS or COMPONENTS[name][0] != part:
        raise NotImplementedError(f"{part} '{name}' is not ported to anemoi_tpu_torch")
    _, cls, ported, other = COMPONENTS[name]
    cfg.pop("edge_provider", None)
    if cfg.get("shard_strategy", "none") not in STRATEGIES:
        raise ValueError(f"{part}: unknown shard_strategy {cfg['shard_strategy']} "
                         f"(known: {STRATEGIES})")
    if "num_heads" in ported and "num_heads" not in cfg:
        raise ValueError(f"{part}: num_heads is required")
    for key in ("sub_graph_edge_attributes", "trainable_size"):
        cfg.pop(key, None)
    dropped = sorted(k for k in cfg if k not in ported and k not in other)
    if dropped:
        LOGGER.warning("%s %s: ignoring config keys %s, as the JAX package does", part, name,
                       dropped)
    kwargs = {k: cfg[k] for k in ported if k in cfg}
    if "scan_unroll" in kwargs:
        kwargs["scan_unroll"] = int(kwargs["scan_unroll"])
    return name, cls, kwargs


STRATEGIES = ("none", "gspmd", "edges", "heads")
# residuals that read other grid rows than their own
ROW_MIXING_RESIDUALS = ("TruncatedConnection", "SpectralOrnsteinConnection")
# processors whose attention heads the heads (Ulysses) strategy splits
HEADS_PROCESSORS = ("GraphTransformerProcessor", "TransformerProcessor")


def component_name(config: dict, part: str) -> str:
    return str((config.get(part) or {}).get("name", _DEFAULT_NAMES[part]))


def mapper_shard(name: str, sub: SubGraphArrays, group, num_shards: int, index: int,
                 overlap: bool, runtime: bool = False):
    """A mapper's share of its edge set on rank ``index`` of the model group:
    the halo (a ``HaloShard``) for the GraphTransformer and GNN mappers, the
    rank's destination and source blocks (a ``BlockShard``) for the
    point-wise and cross-attention mappers and a runtime (``DynamicKNN``)
    set.  ``halo_overlap`` splits interior and boundary rows of a
    GraphTransformer set."""
    if runtime or name not in EDGE_COMPONENTS:
        return BlockShard(group, num_shards, index, sub.num_dst, sub.num_src)
    return sub.sharded_edge_data(num_shards, index, group,
                                 overlap and name.startswith("GraphTransformer"))


def processor_shard(name: str, sub: SubGraphArrays, processor: nn.Module, group,
                    num_shards: int, index: int, overlap: bool, heads: bool):
    """A processor's share of the ``sub.num_dst`` hidden rows: a
    ``HeadsShard`` under ``heads`` (GraphTransformer, Transformer), the band
    halo for the Transformer, the rank's block for the point-wise
    processor, the halo for the GraphTransformer and GNN."""
    n = sub.num_dst
    if heads and name in HEADS_PROCESSORS:
        return HeadsShard(group, num_shards, index, n, sub if name in EDGE_COMPONENTS else None)
    if name == "PointWiseMLPProcessor":
        return BlockShard(group, num_shards, index, n, n)
    if name == "TransformerProcessor":
        attention = processor.proc[0].attention if processor is not None else None
        return BandShard.build(group, num_shards, index, n,
                               None if attention is None else attention.window_size,
                               "xla" if attention is None else attention.attention_impl,
                               sub.edge_index.device)
    return sub.sharded_edge_data(num_shards, index, group,
                                 overlap and name.startswith("GraphTransformer"))


def call_processor(processor: nn.Module, x: torch.Tensor, sub, edge_attr, cond, edges: bool):
    """A processor on the rank's rows: over its edge set (or its shard of
    it), or with its sequence shard (``heads``, the band halo), or alone."""
    if edges:
        return processor(x, sub, edge_attr, cond)
    if isinstance(sub, (HeadsShard, BandShard)):
        return processor(x, cond, shard=sub)
    return processor(x, cond)


def shard_strategy(config: dict) -> str:
    """The model-parallel strategy of a model config (JAX
    ``AnemoiModelEncProcDec.shard_strategy``): ``none``, ``gspmd`` (alias
    ``shard_over_mesh``), ``edges`` (the halo exchange) or ``heads``.
    ``gspmd`` on a GraphTransformer processor with ``num_model_shards`` > 1
    becomes ``edges``, as the JAX package upgrades it on its paged backend;
    the port has no GSPMD, so it takes the upgrade whatever
    ``graph_attention_backend`` says (``gspmd_paged_upgrade: false`` keeps
    ``gspmd``).  ``none`` with ``num_model_shards`` > 1 is what the JAX
    package runs as GSPMD propagation from the grid-sharded batch, and so
    takes the same name as ``gspmd``.  The port has no GSPMD: every name
    runs each component on its route (:func:`mapper_shard`,
    :func:`processor_shard`)."""
    s = str(config.get("shard_strategy", "none"))
    shards = int(config.get("num_model_shards", 1))
    if s == "none" and (config.get("shard_over_mesh", False) or shards > 1):
        s = "gspmd"
    processor = str((config.get("processor") or {}).get("name", _DEFAULT_NAMES["processor"]))
    if (s == "gspmd" and shards > 1 and bool(config.get("gspmd_paged_upgrade", True))
            and processor.startswith("GraphTransformer")):
        return "edges"
    return s


def fused_backward(config: dict, part: str, num_edges: int, num_channels: int) -> bool:
    """The JAX package's choice of attention backward for one edge set
    (``encoder_processor_decoder.py:284-315``): ``paged_fused_bwd`` for the
    processor and, unless ``paged_mapper_fused_bwd`` overrides it, for the
    mappers; a mapper with neither mapper key set (nor ``paged_mapper_block``)
    also takes the fused backward when the two-pass transient it estimates,
    ``E * 1.7 * 3 * C * 2`` bytes, exceeds 2 GB.  That estimate is the TPU
    layout's (1.7 is the padding of its paged slots) and is kept so both
    packages choose the same backward; the port's per-edge buffer is exactly
    ``E * 2C`` elements, and the threshold is not measured on the GPU."""
    fused = bool(config.get("paged_fused_bwd", False))
    if part == "processor":
        return fused
    mapper_key = config.get("paged_mapper_fused_bwd")
    if mapper_key is not None:
        return bool(mapper_key)
    auto = "paged_mapper_block" not in config
    return fused or (auto and num_edges * 1.7 * 3 * num_channels * 2 > 2e9)


def dynamic_knn(config: dict, part: str) -> Optional[dict]:
    """The ``DynamicKNN`` edge provider of the ``encoder`` or ``decoder``
    config, or None (no provider, or another one, which the JAX package
    drops)."""
    provider = (config.get(part) or {}).get("edge_provider")
    if not provider or provider.get("name") != "DynamicKNN":
        return None
    provider = dict(provider)
    attrs = tuple(provider.get("attributes", ("edge_dirs", "edge_length")))
    unknown = [a for a in attrs if a not in ATTRIBUTE_WIDTHS]
    if unknown:
        raise ValueError(f"{part}: unsupported runtime edge attributes {unknown} "
                         f"(known: {sorted(ATTRIBUTE_WIDTHS)})")
    provider["attributes"] = attrs
    provider["k"] = int(provider.get("num_nearest_neighbours", 3))
    return provider


def dynamic_subgraph(provider: dict, src_feat: torch.Tensor, dst_feat: torch.Tensor,
                     dtype: torch.dtype, fused_bwd: bool,
                     shard: Optional[BlockShard] = None) -> SubGraphArrays:
    """The runtime kNN sub-graph of one mapper from its node sets' float32
    sincos features: edges, device source order and attributes (in
    ``dtype``, the static sets' type), as K1 / K3 / K4 take them.  With a
    ``shard`` (model shards): the set of the rank's destination rows over
    every source (global source ids), its attributes normalised over the
    whole set, as one process normalises them (every rank's picks are
    gathered, a few bytes an edge)."""
    from anemoi_tpu_torch.parallel.rows import all_gather_blocks

    k = provider["k"]
    rows = None if shard is None else shard.dst_rows
    edges = runtime_knn(src_feat, dst_feat, k, rows)
    whole = edges.edge_index
    if shard is not None:
        picks = all_gather_blocks(edges.edge_index[0].reshape(-1, k), 0, shard.group,
                                  shard.num_dst, shard.num_shards)
        dst = torch.arange(shard.num_dst, dtype=torch.int32, device=picks.device)
        whole = torch.stack([picks.reshape(-1), dst.repeat_interleave(k)])
    attr = runtime_edge_attributes(src_feat, dst_feat, whole, provider["attributes"])
    if rows is not None:
        attr = attr[rows.start * k : rows.stop * k]
    return SubGraphArrays(
        edge_index=edges.edge_index, dst_ptr=edges.dst_ptr, edge_attr=attr.to(dtype),
        num_src=edges.num_src, num_dst=edges.num_dst, src_ptr=edges.source.src_ptr,
        src_perm=edges.source.src_perm, fused_bwd=fused_bwd,
    )


class AnemoiModelEncProcDec(nn.Module):
    """The deterministic encoder-processor-decoder.  ``statistics`` (per
    dataset) seeds a ``ScalarOrnsteinConnection``'s theta, as in the JAX
    package."""

    fcstep_input = False  # the ensemble model's forecast-step input channel
    runtime_edges = True  # a DynamicKNN provider replaces a mapper's edges

    def __init__(
        self, *, graph: ModelGraph, data_indices: Dict[str, IndexCollection], config: dict,
        statistics: Optional[Dict[str, dict]] = None,
    ) -> None:
        super().__init__()
        self._init_common(graph, data_indices, config)
        hidden = graph.hidden_name
        trainable = config.get("trainable_parameters") or {}
        datasets = sorted(data_indices)

        self.node_attributes = NamedNodesAttributes(
            {name: graph.num_nodes[name] for name in [*datasets, hidden]}, trainable
        )
        n_hidden_attr = graph.node_features[hidden].shape[1] + int(trainable.get(hidden, 0))

        def trainable_size(part):
            return int((config.get(part) or {}).get("trainable_size", 0))

        self.dynamic = {part: dynamic_knn(config, part) if self.runtime_edges else None
                        for part in ("encoder", "decoder")}

        def edge_dim(part, sub):
            provider = self.dynamic.get(part)
            if provider is None:
                return sub.edge_dim + trainable_size(part)
            return sum(ATTRIBUTE_WIDTHS[a] for a in provider["attributes"]) + trainable_size(part)

        def num_edges(part, ds):
            provider = self.dynamic[part]
            if provider is None:
                return getattr(graph, part)[ds].num_edges
            return graph.num_nodes[hidden if part == "encoder" else ds] * provider["k"]

        (enc_name, enc_cls, enc), (proc_name, proc_cls, proc), (dec_name, dec_cls, dec) = (
            _component(config, p) for p in ("encoder", "processor", "decoder"))
        self.processor_edges = proc_name in EDGE_COMPONENTS
        c = self.num_channels
        self.noise_injector = self._noise_injector()
        if self._processor_conditional() and proc_name in (
                "GraphTransformerProcessor", "TransformerProcessor"):
            cond_dim = self._conditioning_dim()
            if cond_dim is None:
                raise ValueError("processor.conditional needs the conditioning of an "
                                 "AnemoiEnsModelEncProcDec with the NoiseConditioning injector "
                                 "or of a transport model")
            proc["cond_dim"] = cond_dim
        if self._mapper_conditioning_dim() is not None:
            enc["cond_dim"] = dec["cond_dim"] = self._mapper_conditioning_dim()
        for part, subs in (("encoder", graph.encoder.values()), ("processor", [graph.processor]),
                           ("decoder", graph.decoder.values())):
            for sub in subs:
                sub.fused_bwd = fused_backward(config, part, sub.num_edges, c)
        self.encoder = nn.ModuleDict({
            ds: enc_cls(self.input_dim(ds, trainable), n_hidden_attr, c,
                        edge_dim=edge_dim("encoder", graph.encoder[ds]), **enc)
            for ds in datasets
        })
        if self.processor_edges:
            proc["edge_dim"] = edge_dim("processor", graph.processor)
        self.processor = proc_cls(num_channels=c, **proc)
        # the decoder's data-node input: the encoder's first output, the raw
        # input (GT, point-wise) or its embedding, updated (GNN)
        self.decoder = nn.ModuleDict({
            ds: dec_cls(c if enc_name == "GNNForwardMapper"
                        else self.input_dim(ds, trainable),
                        c, self.output_dim(ds), edge_dim=edge_dim("decoder", graph.decoder[ds]),
                        **dec)
            for ds in datasets
        })
        # trainable edge features live on the graph providers, as in anemoi-core
        if trainable_size("encoder") and enc_name in EDGE_COMPONENTS:
            self.encoder_graph_provider = nn.ModuleDict({
                ds: TrainableEdgeFeatures(num_edges("encoder", ds), trainable_size("encoder"))
                for ds in datasets
            })
        if trainable_size("processor") and self.processor_edges:
            self.processor_graph_provider = TrainableEdgeFeatures(
                graph.processor.num_edges, trainable_size("processor")
            )
        if trainable_size("decoder") and dec_name in EDGE_COMPONENTS:
            self.decoder_graph_provider = nn.ModuleDict({
                ds: TrainableEdgeFeatures(num_edges("decoder", ds), trainable_size("decoder"))
                for ds in datasets
            })

        self._init_output(statistics)

    def _init_common(self, graph: ModelGraph, data_indices: Dict[str, IndexCollection],
                     config: dict) -> None:
        """The config's checks and the settings every model of the family
        reads."""
        self.config = config
        if str(config.get("graph_attention_backend", "padded")) not in BACKENDS:
            raise ValueError(f"unknown graph_attention_backend {config['graph_attention_backend']}")
        self._check_sharding(config)
        self.dynamic: Dict[str, Optional[dict]] = {}  # the mappers' DynamicKNN providers
        self.graph = graph
        self.data_indices = data_indices
        self.num_channels = int(config["num_channels"])
        self.n_step_input = int(config.get("n_step_input", 2))
        self.n_step_output = int(config.get("n_step_output", 1))
        self.latent_skip = bool(config.get("latent_skip", True))

    def _check_sharding(self, config: dict) -> None:
        """Read the model-parallel settings: ``num_model_shards``,
        ``model_parallel``, the strategy, each component's name and whether
        the processor splits heads; ``halo`` (the rank's shares) is built
        by :meth:`shard_over`."""
        strategy = shard_strategy(config)
        if strategy not in STRATEGIES:
            raise ValueError(f"unknown shard_strategy {strategy} (known: {STRATEGIES})")
        self.num_model_shards = int(config.get("num_model_shards", 1))
        self.strategy = strategy
        self.halo = None
        self.model_parallel = self.num_model_shards > 1
        self.overlap = bool(config.get("halo_overlap", True))
        self.names = {part: component_name(config, part)
                      for part in ("encoder", "processor", "decoder")}
        # the processor's own strategy, else the model's
        proc_strategy = str((config.get("processor") or {}).get("shard_strategy", strategy))
        self.processor_heads = (proc_strategy == "heads"
                                and self.names["processor"] in HEADS_PROCESSORS)
        if self.model_parallel and self.processor_heads:
            heads = int((config.get("processor") or {}).get("num_heads", 0))
            if heads % self.num_model_shards:
                raise ValueError(f"num_model_shards {self.num_model_shards}: the processor's "
                                 f"num_heads {heads} is not divisible by the model group "
                                 "(shard_strategy heads)")

    def _mesh_group(self, mesh):
        """``(group, size, index)`` of ``mesh``'s model group, which must
        have ``num_model_shards`` ranks."""
        s = self.num_model_shards
        if mesh is None or mesh.size("model") != s:
            raise ValueError(f"num_model_shards {s} needs a mesh whose model group has {s} "
                             f"ranks, got {None if mesh is None else mesh.spec}")
        return mesh.group("model"), s, mesh.index("model")

    def shard_over(self, mesh) -> None:
        """Build this rank's share of every edge set and node set over
        ``mesh``'s model group (JAX ``build_graph_inputs`` under model
        shards), each by its component's route; a no-op without model
        shards.  Called once by the interface: training and serving share
        the tables."""
        if not self.model_parallel:
            return
        group, s, index = self._mesh_group(mesh)
        g = self.graph

        def mapper(part, sub):
            return mapper_shard(self.names[part], sub, group, s, index, self.overlap,
                                runtime=self.dynamic.get(part) is not None)

        processor = processor_shard(self.names["processor"], g.processor, self.processor, group,
                                    s, index, self.overlap, self.processor_heads)
        self.halo = {
            "encoder": {ds: mapper("encoder", sub) for ds, sub in g.encoder.items()},
            "processor": processor,
            "decoder": {ds: mapper("decoder", sub) for ds, sub in g.decoder.items()},
        }
        for ds, enc in self.halo["encoder"].items():
            if enc.src_rows != self.halo["decoder"][ds].dst_rows:
                raise AssertionError(f"{ds}: the encoder and decoder split the grid differently")
            if (enc.dst_rows, enc.n_local) != (processor.dst_rows, processor.n_local):
                raise AssertionError(f"{ds}: the encoder and processor split the mesh differently")
            if self.names["encoder"].startswith("PointWise") and enc.src_rows != enc.dst_rows:
                raise AssertionError(f"{ds}: a point-wise mapper's grid and mesh rows differ")

    def grid_rows(self, ds: str) -> slice:
        """This rank's rows of dataset ``ds``'s grid (all of them without
        model shards)."""
        if self.halo is None:
            return slice(0, self.graph.num_nodes[ds])
        return self.halo["encoder"][ds].src_rows

    def hidden_rows(self) -> slice:
        if self.halo is None:
            return slice(0, self.graph.num_nodes[self.graph.hidden_name])
        return self.halo["processor"].dst_rows

    def _build_residual(self, ds: str, statistics: Optional[dict]) -> nn.Module:
        return build_residual(self.config.get("residual"), self.data_indices[ds], statistics,
                              graph=self.graph.source_graph, dataset=ds)

    def _init_output(self, statistics: Optional[Dict[str, dict]]) -> None:
        """Per dataset: the residual, the boundings and the prognostic
        residual's gather."""
        config, data_indices = self.config, self.data_indices
        datasets = sorted(data_indices)
        statistics = statistics or {}
        self.residual = nn.ModuleDict({
            ds: self._build_residual(ds, statistics.get(ds)) for ds in datasets
        })
        self.boundings = nn.ModuleDict({
            ds: build_boundings(config.get("bounding"),
                                data_indices[ds].model.output.name_to_index)
            for ds in datasets
        })

        # prognostic residual: per output variable, the input variable to add
        for ds in datasets:
            idx = data_indices[ds]
            add_mask = torch.zeros(idx.num_model_output_vars, dtype=torch.bool)
            skip_gather = torch.zeros(idx.num_model_output_vars, dtype=torch.long)
            add_mask[torch.as_tensor(idx.model.output.prognostic, dtype=torch.long)] = True
            skip_gather[torch.as_tensor(idx.model.output.prognostic, dtype=torch.long)] = (
                torch.as_tensor(idx.model.input.prognostic, dtype=torch.long)
            )
            self.register_buffer(f"add_mask_{ds}", add_mask, persistent=False)
            self.register_buffer(f"skip_gather_{ds}", skip_gather, persistent=False)

    def _noise_injector(self) -> Optional[nn.Module]:
        """The noise injector between encoder and processor: none here."""
        return None

    def _processor_conditional(self) -> bool:
        return bool((self.config["processor"] or {}).get("conditional"))

    def _conditioning_dim(self) -> Optional[int]:
        """The width of the processor's conditioning: the noise injector's."""
        return getattr(self.noise_injector, "conditioning_dim", None)

    def _mapper_conditioning_dim(self) -> Optional[int]:
        """The width of the mappers' conditioning: none here."""
        return None

    def noise_shape(self, x: Dict[str, torch.Tensor]):
        """The shape of the standard normal draw the model needs for inputs
        ``x`` (``[B·M, N_hidden, noise_channels_dim]``), or None if it draws
        none."""
        if self.noise_injector is None or not self.noise_injector.draws_noise:
            return None
        some = next(iter(x.values()))
        return self.noise_injector.noise_shape(some.shape[0] * some.shape[2],
                                               self.graph.num_nodes[self.graph.hidden_name])

    def input_dim(self, ds: str, trainable: dict) -> int:
        return (
            self.n_step_input * self.data_indices[ds].num_model_input_vars
            + self.graph.node_features[ds].shape[1]
            + int(trainable.get(ds, 0))
            + int(self.fcstep_input)
        )

    def output_dim(self, ds: str) -> int:
        return self.n_step_output * self.data_indices[ds].num_model_output_vars

    def _mapper_edges(self, part: str, src: str, dst: str, static) -> SubGraphArrays:
        """The mapper's edge set: the static one, or its ``DynamicKNN``
        provider's, built now from the node sets' coordinates (under model
        shards: the rank's destinations' edges)."""
        provider = self.dynamic[part]
        if provider is None:
            return static
        feats = self.graph.node_features_f32
        fused = fused_backward(self.config, part, self.graph.num_nodes[dst] * provider["k"],
                               self.num_channels)
        # the mapper's dataset: its source set (encoder) or destination set
        shard = None if self.halo is None else self.halo[part][src if part == "encoder" else dst]
        return dynamic_subgraph(provider, feats[src], feats[dst], static.edge_attr.dtype, fused,
                                shard)

    def _edges(self, provider: str, sub, ds: str | None = None) -> torch.Tensor:
        trainable = getattr(self, provider, None)
        if trainable is None:
            return sub.edge_attr
        module = trainable[ds] if ds is not None else trainable
        part = provider.split("_")[0]
        if self.halo is not None and self.dynamic.get(part) is not None:
            # the rank's edges of the runtime set: k a destination row
            rows, k = self.halo[part][ds].dst_rows, self.dynamic[part]["k"]
            return module(sub.edge_attr, slice(rows.start * k, rows.stop * k))
        return module(sub.edge_attr)

    def _set(self, part: str, ds: str, sub=None):
        """A mapper's sub-graph: ``sub`` (default: the graph's), or this
        rank's share of it under model shards (with a runtime set, the
        rank's ``BlockShard`` carrying it)."""
        if self.halo is not None:
            shard = self.halo[part][ds]
            return shard.with_sub(sub) if self.dynamic.get(part) is not None else shard
        return getattr(self.graph, part)[ds] if sub is None else sub

    def _skip(self, ds: str, x: torch.Tensor) -> torch.Tensor:
        """The residual's skip state of the rank's grid rows; a residual
        that mixes grid rows runs on the whole grid, gathered over the
        model group (its backward sums the ranks' cotangents onto each
        row's owner), and keeps the rank's rows."""
        residual = self.residual[ds]
        if self.halo is None or type(residual).__name__ not in ROW_MIXING_RESIDUALS:
            return residual(x, n_step_output=self.n_step_output)
        shard, rows = self.halo["encoder"][ds], self.grid_rows(ds)
        whole = gather_blocks(x, 3, shard.group, shard.num_src, shard.num_shards, shard.index)
        out = residual(whole, n_step_output=self.n_step_output)
        return out.narrow(3, rows.start, rows.stop - rows.start)

    def _run_processor(self, x_latent: torch.Tensor, cond: Optional[torch.Tensor], call=plain):
        """The processor on the rank's hidden rows: over the processor set or
        the rank's share of it (``call_processor``), through ``call``
        (``utils/tracing.components``)."""
        graph, halo = self.graph, self.halo
        sub = graph.processor if halo is None else halo["processor"]
        edges = (self._edges("processor_graph_provider", graph.processor)
                 if self.processor_edges else None)
        return call(
            "processor", lambda x, e, c: call_processor(self.processor, x, sub, e, c,
                                                        self.processor_edges),
            x_latent, edges, cond)

    def forward(self, x: Dict[str, torch.Tensor], cond: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None, fcstep: int = 0) -> Dict[str, torch.Tensor]:
        """x[ds]: [B, T, E, G, V_model_in] in the compute type (under model
        shards, G is this rank's :meth:`grid_rows`); ``cond``: the
        processor's conditioning (default: the noise injector's); ``noise``:
        the noise injector's standard normal draw (``noise_shape(x)``);
        ``fcstep``: the rollout step (the ensemble model's input channel).
        Returns {ds: [B, n_step_output, E, G, V_model_out]}.  The encoder,
        processor and decoder calls run under the profiler's spans
        ``anemoi.model.<part>`` (``utils/tracing.components``)."""
        graph = self.graph
        hidden = graph.hidden_name
        datasets = sorted(x)
        some = x[datasets[0]]
        batch, n_time, ens = some.shape[:3]
        if n_time != self.n_step_input:
            raise ValueError(f"Expected {self.n_step_input} input steps, got {n_time}")
        bflat = batch * ens
        dt = some.dtype

        halo = self.halo
        hidden_attrs = self.node_attributes(hidden, graph.node_features[hidden].to(dt))
        hidden_attrs = hidden_attrs[self.hidden_rows()]
        x_hidden_latent = hidden_attrs[None].expand((bflat,) + hidden_attrs.shape)

        call = components()
        x_skip, x_data_latent, latents = {}, {}, []
        for ds in datasets:
            xd = x[ds]
            x_skip[ds] = self._skip(ds, xd)
            node_attrs = self.node_attributes(ds, graph.node_features[ds].to(dt))
            node_attrs = node_attrs[self.grid_rows(ds)]
            # [B,T,E,G,V] -> [(B E), G, (T V)]
            flat = xd.permute(0, 2, 3, 1, 4).reshape(bflat, xd.shape[3], n_time * xd.shape[4])
            parts = [flat, node_attrs[None].expand((bflat,) + node_attrs.shape)]
            if self.fcstep_input:
                # [x, node attrs, fcstep], the step clamped to min(1, fcstep)
                parts.append(flat.new_full((bflat, xd.shape[3], 1), float(min(1, fcstep))))
            x_latent_in = torch.cat(parts, dim=-1)
            sub = self._mapper_edges("encoder", ds, hidden, graph.encoder[ds])
            encoder, mapper_set = self.encoder[ds], self._set("encoder", ds, sub)
            x_data_latent[ds], x_latent = call(
                "encoder", lambda src, dst, edges: encoder((src, dst), mapper_set, edges),
                x_latent_in, x_hidden_latent, self._edges("encoder_graph_provider", sub, ds))
            latents.append(x_latent)

        x_latent = sum(latents)
        noise_cond = None
        if self.noise_injector is not None:
            if halo is not None and noise is not None:
                noise = noise[:, self.hidden_rows()]  # every rank draws the whole mesh's
            x_latent, noise_cond = self.noise_injector(x_latent, noise)
        if cond is None:
            cond = noise_cond
        x_latent_proc = self._run_processor(x_latent, cond, call)
        if self.latent_skip:
            x_latent_proc = x_latent_proc + x_latent

        out = {}
        for ds in datasets:
            idx = self.data_indices[ds]
            sub = self._mapper_edges("decoder", hidden, ds, graph.decoder[ds])
            decoder, mapper_set = self.decoder[ds], self._set("decoder", ds, sub)
            x_out = call(
                "decoder", lambda src, dst, edges: decoder((src, dst), mapper_set, edges),
                x_latent_proc, x_data_latent[ds], self._edges("decoder_graph_provider", sub, ds))
            # [(B E), G, (T V)] -> [B, T, E, G, V]
            x_out = x_out.reshape(batch, ens, x_out.shape[1], self.n_step_output,
                                  idx.num_model_output_vars).permute(0, 3, 1, 2, 4)
            add_mask = getattr(self, f"add_mask_{ds}")
            skip = x_skip[ds][..., getattr(self, f"skip_gather_{ds}")]
            x_out = x_out + torch.where(add_mask, skip, torch.zeros((), dtype=skip.dtype,
                                                                     device=skip.device))
            for bounding in self.boundings[ds]:
                x_out = bounding(x_out)
            out[ds] = x_out
        return out


class AnemoiModelAutoEncoder(AnemoiModelEncProcDec):
    """The encoder-decoder of the autoencoder task: the same model, which the
    ``autoencoder`` preset configures with ``NoResidualConnection`` and a
    point-wise processor on a graph without processor edges (the JAX
    package's subclass has no code of its own either)."""


class AnemoiEnsModelEncProcDec(AnemoiModelEncProcDec):
    """The ensemble model: every member (dim 2 of the input) runs through the
    same weights with its own noise draw, injected between encoder and
    processor by ``model.noise_injector`` (default ``NoiseConditioning``,
    whose conditioning needs ``processor.conditional: true``); the encoder
    input carries the forecast-step channel unless ``fcstep_input: false``."""

    @property
    def fcstep_input(self) -> bool:
        return bool(self.config.get("fcstep_input", True))

    def _noise_injector(self) -> nn.Module:
        return build_noise_injector(self.config.get("noise_injector"), self.num_channels)
