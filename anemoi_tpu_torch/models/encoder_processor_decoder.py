"""Encoder-processor-decoder graph model.

Port of ``anemoi_tpu.models.encoder_processor_decoder.AnemoiModelEncProcDec``
with the GraphTransformer mappers and processor.  Data flow, per dataset:
[B,T,E,G,V] -> [(B E), G, (T V)], node attributes appended -> encoder
(data -> hidden) -> sum of the latents -> processor over the hidden mesh ->
latent skip -> decoder (hidden -> data) -> [B,T,E,G,V] -> residual added on
the prognostic variables.

Ported: the deterministic model on one device.  Bounding, non-skip
residuals, the ensemble noise and forecast-step channel, conditional norms,
dynamic edge providers and model parallelism raise ``NotImplementedError``.
The ``graph_attention_backend`` values of the JAX package (paged, padded,
segment) all select the port's one CSR attention.  Its backward on each edge
set follows the JAX package's choice between the two-pass and the fused
backward (:func:`fused_backward`).
"""

from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.models.graph import ModelGraph
from anemoi_tpu_torch.models.layers.embed import NamedNodesAttributes
from anemoi_tpu_torch.models.layers.mapper import (
    GraphTransformerBackwardMapper,
    GraphTransformerForwardMapper,
    TrainableEdgeFeatures,
)
from anemoi_tpu_torch.models.layers.processor import GraphTransformerProcessor
from anemoi_tpu_torch.models.layers.residual import build_residual

BACKENDS = ("paged", "padded", "segment")
_COMPONENT_NAMES = {
    "encoder": "GraphTransformerForwardMapper",
    "processor": "GraphTransformerProcessor",
    "decoder": "GraphTransformerBackwardMapper",
}
_MATH_KEYS = ("num_heads", "mlp_hidden_ratio", "attn_channels", "qk_norm", "edge_pre_mlp")


def _component(config: dict, part: str) -> dict:
    """Constructor kwargs of one GraphTransformer component; keys that only
    steer the TPU's execution (remat, scan, tables) are dropped, keys that
    change the math and are not ported raise."""
    cfg = dict(config.get(part) or {})
    name = cfg.get("name", _COMPONENT_NAMES[part])
    if name != _COMPONENT_NAMES[part]:
        raise NotImplementedError(f"{part} '{name}' is not ported to anemoi_tpu_torch")
    if cfg.get("edge_provider"):
        raise NotImplementedError(f"{part}: dynamic edge providers are not ported")
    if cfg.get("conditional"):
        raise NotImplementedError(f"{part}: conditional layer norms are not ported")
    if cfg.get("mlp_implementation", "mlp") != "mlp":
        raise NotImplementedError(f"{part}: gated MLPs are not ported")
    if cfg.get("qk_norm_type", "layernorm") != "layernorm":
        raise NotImplementedError(f"{part}: only the layernorm qk-norm is ported")
    if int(cfg.get("scan_unroll", 1)) != 1:
        raise NotImplementedError(f"{part}: scan_unroll > 1 stacks parameters differently")
    if "num_heads" not in cfg:
        raise ValueError(f"{part}: num_heads is required")
    return {k: cfg[k] for k in _MATH_KEYS if k in cfg}


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


class AnemoiModelEncProcDec(nn.Module):
    """The deterministic encoder-processor-decoder."""

    def __init__(
        self, *, graph: ModelGraph, data_indices: Dict[str, IndexCollection], config: dict
    ) -> None:
        super().__init__()
        if config.get("bounding"):
            raise NotImplementedError("output bounding is not ported to anemoi_tpu_torch")
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
        self.residual = build_residual(config.get("residual"))
        hidden = graph.hidden_name
        trainable = config.get("trainable_parameters") or {}
        datasets = sorted(data_indices)

        self.node_attributes = NamedNodesAttributes(
            {name: graph.num_nodes[name] for name in [*datasets, hidden]}, trainable
        )
        n_hidden_attr = graph.node_features[hidden].shape[1] + int(trainable.get(hidden, 0))

        def trainable_size(part):
            return int((config.get(part) or {}).get("trainable_size", 0))

        def edge_dim(part, sub):
            return sub.edge_dim + trainable_size(part)

        enc, proc, dec = (_component(config, p) for p in ("encoder", "processor", "decoder"))
        c = self.num_channels
        for part, subs in (("encoder", graph.encoder.values()), ("processor", [graph.processor]),
                           ("decoder", graph.decoder.values())):
            for sub in subs:
                sub.fused_bwd = fused_backward(config, part, sub.num_edges, c)
        self.encoder = nn.ModuleDict({
            ds: GraphTransformerForwardMapper(
                self.input_dim(ds, trainable), n_hidden_attr, c,
                edge_dim=edge_dim("encoder", graph.encoder[ds]), **enc,
            ) for ds in datasets
        })
        self.processor = GraphTransformerProcessor(
            int(config["processor"]["num_layers"]), c,
            edge_dim=edge_dim("processor", graph.processor), **proc,
        )
        self.decoder = nn.ModuleDict({
            ds: GraphTransformerBackwardMapper(
                self.input_dim(ds, trainable), c, self.output_dim(ds),
                edge_dim=edge_dim("decoder", graph.decoder[ds]), **dec,
            ) for ds in datasets
        })
        # trainable edge features live on the graph providers, as in anemoi-core
        if trainable_size("encoder"):
            self.encoder_graph_provider = nn.ModuleDict({
                ds: TrainableEdgeFeatures(graph.encoder[ds].num_edges, trainable_size("encoder"))
                for ds in datasets
            })
        if trainable_size("processor"):
            self.processor_graph_provider = TrainableEdgeFeatures(
                graph.processor.num_edges, trainable_size("processor")
            )
        if trainable_size("decoder"):
            self.decoder_graph_provider = nn.ModuleDict({
                ds: TrainableEdgeFeatures(graph.decoder[ds].num_edges, trainable_size("decoder"))
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

    def input_dim(self, ds: str, trainable: dict) -> int:
        return (
            self.n_step_input * self.data_indices[ds].num_model_input_vars
            + self.graph.node_features[ds].shape[1]
            + int(trainable.get(ds, 0))
        )

    def output_dim(self, ds: str) -> int:
        return self.n_step_output * self.data_indices[ds].num_model_output_vars

    def _edges(self, provider: str, sub, ds: str | None = None) -> torch.Tensor:
        trainable = getattr(self, provider, None)
        if trainable is None:
            return sub.edge_attr
        return (trainable[ds] if ds is not None else trainable)(sub.edge_attr)

    def forward(self, x: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """x[ds]: [B, T, E, G, V_model_in] in the compute type.
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
            x_skip[ds] = self.residual(xd, n_step_output=self.n_step_output)
            node_attrs = self.node_attributes(ds, graph.node_features[ds].to(dt))
            # [B,T,E,G,V] -> [(B E), G, (T V)]
            flat = xd.permute(0, 2, 3, 1, 4).reshape(bflat, xd.shape[3], n_time * xd.shape[4])
            x_latent_in = torch.cat(
                [flat, node_attrs[None].expand((bflat,) + node_attrs.shape)], dim=-1
            )
            sub = graph.encoder[ds]
            x_data_latent[ds], x_latent = self.encoder[ds](
                (x_latent_in, x_hidden_latent), sub, self._edges("encoder_graph_provider", sub, ds)
            )
            latents.append(x_latent)

        x_latent = sum(latents)
        x_latent_proc = self.processor(
            x_latent, graph.processor, self._edges("processor_graph_provider", graph.processor)
        )
        if self.latent_skip:
            x_latent_proc = x_latent_proc + x_latent

        out = {}
        for ds in datasets:
            idx = self.data_indices[ds]
            sub = graph.decoder[ds]
            x_out = self.decoder[ds](
                (x_latent_proc, x_data_latent[ds]), sub,
                self._edges("decoder_graph_provider", sub, ds),
            )
            # [(B E), G, (T V)] -> [B, T, E, G, V]
            x_out = x_out.reshape(batch, ens, x_out.shape[1], self.n_step_output,
                                  idx.num_model_output_vars).permute(0, 3, 1, 2, 4)
            add_mask = getattr(self, f"add_mask_{ds}")
            skip = x_skip[ds][..., getattr(self, f"skip_gather_{ds}")]
            out[ds] = x_out + torch.where(add_mask, skip, torch.zeros((), dtype=skip.dtype,
                                                                       device=skip.device))
        return out
