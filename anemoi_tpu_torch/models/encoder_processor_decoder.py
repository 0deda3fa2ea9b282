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
Ported: every model on one device.  Model parallelism raises
``NotImplementedError``.  The
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
    are dropped silently; Ulysses head sharding, which is not ported,
    raises.  The
    processors' ``conditional`` is applied by the model (the conditioning's
    width); the GT processor's ``scan_unroll`` is checked against its depth,
    as the JAX processor checks it."""
    cfg = dict(config.get(part) or {})
    name = str(cfg.pop("name", _DEFAULT_NAMES[part]))
    if name not in COMPONENTS or COMPONENTS[name][0] != part:
        raise NotImplementedError(f"{part} '{name}' is not ported to anemoi_tpu_torch")
    _, cls, ported, other = COMPONENTS[name]
    cfg.pop("edge_provider", None)
    if cfg.get("shard_strategy", "none") != "none":
        raise NotImplementedError(f"{part}: Ulysses head sharding (shard_strategy) is not ported")
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
                     dtype: torch.dtype, fused_bwd: bool) -> SubGraphArrays:
    """The runtime kNN sub-graph of one mapper from its node sets' float32
    sincos features: edges, device source order and attributes (in
    ``dtype``, the static sets' type), as K1 / K3 / K4 take them."""
    edges = runtime_knn(src_feat, dst_feat, provider["k"])
    attr = runtime_edge_attributes(src_feat, dst_feat, edges.edge_index, provider["attributes"])
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
        strategy = str(config.get("shard_strategy", "none"))
        if strategy != "none" or int(config.get("num_model_shards", 1)) > 1 or config.get(
            "shard_over_mesh"
        ):
            raise NotImplementedError("model parallelism is not ported to anemoi_tpu_torch")
        self.graph = graph
        self.data_indices = data_indices
        self.num_channels = int(config["num_channels"])
        self.n_step_input = int(config.get("n_step_input", 2))
        self.n_step_output = int(config.get("n_step_output", 1))
        self.latent_skip = bool(config.get("latent_skip", True))

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
        provider's, built now from the node sets' coordinates."""
        provider = self.dynamic[part]
        if provider is None:
            return static
        feats = self.graph.node_features_f32
        fused = fused_backward(self.config, part, self.graph.num_nodes[dst] * provider["k"],
                               self.num_channels)
        return dynamic_subgraph(provider, feats[src], feats[dst], static.edge_attr.dtype, fused)

    def _edges(self, provider: str, sub, ds: str | None = None) -> torch.Tensor:
        trainable = getattr(self, provider, None)
        if trainable is None:
            return sub.edge_attr
        return (trainable[ds] if ds is not None else trainable)(sub.edge_attr)

    def forward(self, x: Dict[str, torch.Tensor], cond: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None, fcstep: int = 0) -> Dict[str, torch.Tensor]:
        """x[ds]: [B, T, E, G, V_model_in] in the compute type; ``cond``: the
        processor's conditioning (default: the noise injector's); ``noise``:
        the noise injector's standard normal draw (``noise_shape(x)``);
        ``fcstep``: the rollout step (the ensemble model's input channel).
        Returns {ds: [B, n_step_output, E, G, V_model_out]}."""
        graph = self.graph
        hidden = graph.hidden_name
        datasets = sorted(x)
        some = x[datasets[0]]
        batch, n_time, ens = some.shape[:3]
        if n_time != self.n_step_input:
            raise ValueError(f"Expected {self.n_step_input} input steps, got {n_time}")
        bflat = batch * ens
        dt = some.dtype

        hidden_attrs = self.node_attributes(hidden, graph.node_features[hidden].to(dt))
        x_hidden_latent = hidden_attrs[None].expand((bflat,) + hidden_attrs.shape)

        x_skip, x_data_latent, latents = {}, {}, []
        for ds in datasets:
            xd = x[ds]
            x_skip[ds] = self.residual[ds](xd, n_step_output=self.n_step_output)
            node_attrs = self.node_attributes(ds, graph.node_features[ds].to(dt))
            # [B,T,E,G,V] -> [(B E), G, (T V)]
            flat = xd.permute(0, 2, 3, 1, 4).reshape(bflat, xd.shape[3], n_time * xd.shape[4])
            parts = [flat, node_attrs[None].expand((bflat,) + node_attrs.shape)]
            if self.fcstep_input:
                # [x, node attrs, fcstep], the step clamped to min(1, fcstep)
                parts.append(flat.new_full((bflat, xd.shape[3], 1), float(min(1, fcstep))))
            x_latent_in = torch.cat(parts, dim=-1)
            sub = self._mapper_edges("encoder", ds, hidden, graph.encoder[ds])
            x_data_latent[ds], x_latent = self.encoder[ds](
                (x_latent_in, x_hidden_latent), sub, self._edges("encoder_graph_provider", sub, ds)
            )
            latents.append(x_latent)

        x_latent = sum(latents)
        noise_cond = None
        if self.noise_injector is not None:
            x_latent, noise_cond = self.noise_injector(x_latent, noise)
        if cond is None:
            cond = noise_cond
        if self.processor_edges:
            x_latent_proc = self.processor(
                x_latent, graph.processor, self._edges("processor_graph_provider", graph.processor),
                cond,
            )
        else:
            x_latent_proc = self.processor(x_latent, cond)
        if self.latent_skip:
            x_latent_proc = x_latent_proc + x_latent

        out = {}
        for ds in datasets:
            idx = self.data_indices[ds]
            sub = self._mapper_edges("decoder", hidden, ds, graph.decoder[ds])
            x_out = self.decoder[ds](
                (x_latent_proc, x_data_latent[ds]), sub,
                self._edges("decoder_graph_provider", sub, ds),
            )
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
