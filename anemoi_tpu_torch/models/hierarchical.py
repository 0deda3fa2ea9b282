"""Hierarchical encoder-processor-decoder: a V-cycle over the hidden levels.

Port of ``anemoi_tpu.models.hierarchical``
(``AnemoiModelEncProcDecHierarchical``, ``AnemoiModelHierarchicalAutoEncoder``):

    data -> h_1 -> h_2 -> ... -> h_L -> ... -> h_2 -> h_1 -> data

The encoder maps each dataset onto ``h_1``.  On the way down each level
runs its processor (``down_level_processor.<h>``), then the down mapper
(``downscale.<h>``, built from ``encoder``) onto the next level's node
attributes; the deepest level runs the main ``processor`` with the latent
skip.  On the way up the up mapper (``upscale.<h_i+1>``, built from
``up_mapper`` where the config has it, else from ``decoder``) maps back onto
the state the level had on the way down, that state is added (the skip
across the V), and the level's processor runs again
(``up_level_processor.<h>``).  The decoder maps ``h_1`` onto the data nodes;
the prognostic residual and the boundings follow, as in the flat model.

Level ``i`` runs at ``num_channels * level_channel_ratio**i`` channels
(default ratio 1).  ``level_process_num_layers`` sets the depth of every
level processor but the deepest, which keeps ``processor.num_layers``.
``enable_hierarchical_level_processing`` (alias ``level_process``, default
true) switches every level processor off, the deepest one too.  The levels
are ``hidden_names`` or, without it, the graph's ``hidden*`` node sets
(``models/graph.infer_hidden_names``).  The module names are anemoi-core's,
so ``state_dict_from_jax`` maps the JAX model's ``encoder_<ds>``,
``proc_down_<h>``, ``down_<h>``, ``processor``, ``up_<h>``, ``proc_up_<h>``,
``decoder_<ds>`` onto them; trainable edge features live on the matching
graph providers (``downscale_graph_providers.<h>``, ...).

The attention backward on each sub-graph follows the JAX model's choice:
``paged_fused_bwd`` on the level sets, ``paged_mapper_fused_bwd`` (default:
``paged_fused_bwd``) on the encoder, decoder, down and up sets.  As in the
JAX model, the residual is built without the data indices, so the learnable
``ScalarOrnsteinConnection`` and ``SpectralOrnsteinConnection`` are refused.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from anemoi_tpu_torch.models.encoder_processor_decoder import (
    EDGE_COMPONENTS,
    AnemoiModelEncProcDec,
    _component,
)
from anemoi_tpu_torch.models.layers.embed import NamedNodesAttributes
from anemoi_tpu_torch.models.layers.mapper import TrainableEdgeFeatures
from anemoi_tpu_torch.models.layers.residual import build_residual

_LEARNABLE_RESIDUALS = ("ScalarOrnsteinConnection", "SpectralOrnsteinConnection")


class AnemoiModelEncProcDecHierarchical(AnemoiModelEncProcDec):
    """The multi-level V-cycle model."""

    def __init__(self, *, graph, data_indices, config: dict, statistics=None) -> None:
        nn.Module.__init__(self)
        self._init_common(graph, data_indices, config)
        residual = (config.get("residual") or {}).get("name")
        if residual in _LEARNABLE_RESIDUALS:
            raise ValueError(f"{type(self).__name__} builds its residual without the data "
                             f"indices, so {residual} cannot run in it (the JAX model fails "
                             "its assert); use SkipConnection or NoResidualConnection")
        levels = list(graph.hidden_names)
        if not levels or levels[0] != graph.hidden_name:
            raise ValueError("a hierarchical model needs the hierarchical model graph "
                             "(build_model_graph(..., hidden_names=...))")
        if (config.get("processor") or {}).get("conditional"):
            raise ValueError("processor.conditional needs a conditioning, which the "
                             "hierarchical model has not")
        self.noise_injector = None
        self.hidden_names = levels
        ratio = int(config.get("level_channel_ratio", 1))
        self.dims = [self.num_channels * ratio**i for i in range(len(levels))]
        if "enable_hierarchical_level_processing" in config:
            self.level_process = bool(config["enable_hierarchical_level_processing"])
        else:
            self.level_process = bool(config.get("level_process", True))
        n_level_layers = config.get("level_process_num_layers")
        trainable = config.get("trainable_parameters") or {}
        datasets = sorted(data_indices)
        deepest = len(levels) - 1

        self.node_attributes = NamedNodesAttributes(
            {name: graph.num_nodes[name] for name in [*datasets, *levels]}, trainable)

        def n_attr(name):
            return graph.node_features[name].shape[1] + int(trainable.get(name, 0))

        def trainable_size(cfg):
            return int((cfg or {}).get("trainable_size", 0))

        def component(cfg, part):
            name, cls, kwargs = _component({part: cfg}, part)
            return name, cls, kwargs, trainable_size(cfg)

        def edge_providers(subs, size, name):
            if size and name in EDGE_COMPONENTS:
                return nn.ModuleDict({k: TrainableEdgeFeatures(sub.num_edges, size)
                                      for k, sub in subs.items()})
            return None

        # the attention backward on each edge set (JAX hierarchical.py:89-102)
        fused = bool(config.get("paged_fused_bwd", False))
        mapper_key = config.get("paged_mapper_fused_bwd")
        mapper_fused = fused if mapper_key is None else bool(mapper_key)
        for sub in graph.level.values():
            sub.fused_bwd = fused
        for subs in (graph.encoder, graph.decoder, graph.down, graph.up):
            for sub in subs.values():
                sub.fused_bwd = mapper_fused

        enc_cfg, dec_cfg = config.get("encoder"), config.get("decoder")
        up_cfg = config["up_mapper"] if "up_mapper" in config else dec_cfg
        enc_name, enc_cls, enc, enc_tr = component(enc_cfg, "encoder")
        dec_name, dec_cls, dec, dec_tr = component(dec_cfg, "decoder")
        up_name, up_cls, up, up_tr = component(up_cfg, "decoder")
        c0 = self.dims[0]

        self.encoder = nn.ModuleDict({
            ds: enc_cls(self.input_dim(ds, trainable), n_attr(levels[0]), c0,
                        edge_dim=graph.encoder[ds].edge_dim + enc_tr, **enc)
            for ds in datasets
        })
        self.encoder_graph_provider = edge_providers(graph.encoder, enc_tr, enc_name)

        # the level processors, one component for all: the deepest is the
        # main ``processor``, the others run down and up
        proc_name, proc_cls, proc, proc_tr = component(config["processor"], "processor")
        self.processor_edges = proc_name in EDGE_COMPONENTS
        edge_size = proc_tr if self.processor_edges else 0

        def processor(i, name):
            kwargs = dict(proc)
            if i != deepest and n_level_layers is not None:
                kwargs["num_layers"] = int(n_level_layers)
            if self.processor_edges:
                kwargs["edge_dim"] = graph.level[name].edge_dim + proc_tr
            return proc_cls(num_channels=self.dims[i], **kwargs)

        processed = [(i, name) for i, name in enumerate(levels)
                     if self.level_process and name in graph.level]
        below = [(i, name) for i, name in processed if i != deepest]
        if (deepest, levels[deepest]) in processed:
            self.processor = processor(deepest, levels[deepest])
            if edge_size:
                self.processor_graph_provider = TrainableEdgeFeatures(
                    graph.level[levels[deepest]].num_edges, edge_size)
        for direction in ("down", "up"):
            setattr(self, f"{direction}_level_processor",
                    nn.ModuleDict({name: processor(i, name) for i, name in below}))
            setattr(self, f"{direction}_level_processor_graph_providers", edge_providers(
                {name: graph.level[name] for _, name in below}, edge_size, proc_name))

        # the mappers between levels: down from the encoder's config, onto
        # the next level's node attributes; up from ``up_mapper`` or the
        # decoder's, onto the level's state on the way down
        self.downscale = nn.ModuleDict({
            h: enc_cls(self.dims[i], n_attr(levels[i + 1]), self.dims[i + 1],
                       edge_dim=graph.down[h].edge_dim + enc_tr, **enc)
            for i, h in enumerate(levels[:-1])
        })
        self.downscale_graph_providers = edge_providers(graph.down, enc_tr, enc_name)
        if up_name == "GNNBackwardMapper" and len(set(self.dims)) > 1:
            raise ValueError("a GNNBackwardMapper up mapper adds its output to a state of the "
                             "level's width and needs level_channel_ratio 1 (the JAX model "
                             "fails on the shapes)")
        self.upscale = nn.ModuleDict({
            levels[i + 1]: up_cls(self.dims[i], self.dims[i + 1], self.dims[i],
                                  edge_dim=graph.up[levels[i + 1]].edge_dim + up_tr, **up)
            for i in range(len(levels) - 1)
        })
        self.upscale_graph_providers = edge_providers(graph.up, up_tr, up_name)

        # the decoder's data-node input: the encoder's first output, the raw
        # input (GT, point-wise) or its embedding, updated (GNN)
        self.decoder = nn.ModuleDict({
            ds: dec_cls(c0 if enc_name == "GNNForwardMapper" else self.input_dim(ds, trainable),
                        c0, self.output_dim(ds),
                        edge_dim=graph.decoder[ds].edge_dim + dec_tr, **dec)
            for ds in datasets
        })
        self.decoder_graph_provider = edge_providers(graph.decoder, dec_tr, dec_name)
        self._init_output(statistics)

    def _build_residual(self, ds: str, statistics: Optional[dict]) -> nn.Module:
        return build_residual(self.config.get("residual"), graph=self.graph.source_graph,
                              dataset=ds)

    def _attrs(self, name: str, bflat: int, dt: torch.dtype) -> torch.Tensor:
        attrs = self.node_attributes(name, self.graph.node_features[name].to(dt))
        return attrs[None].expand((bflat,) + attrs.shape)

    def _process(self, proc: nn.Module, x: torch.Tensor, name: str, provider: str,
                 cond: Optional[torch.Tensor]) -> torch.Tensor:
        if not self.processor_edges:
            return proc(x, cond)
        sub = self.graph.level[name]
        key = None if provider == "processor_graph_provider" else name
        return proc(x, sub, self._edges(provider, sub, key), cond)

    def forward(self, x: Dict[str, torch.Tensor], cond: Optional[torch.Tensor] = None,
                noise: Optional[torch.Tensor] = None, fcstep: int = 0) -> Dict[str, torch.Tensor]:
        """x[ds]: [B, T, E, G, V_model_in] in the compute type; ``cond``: the
        conditioning of every level processor.  Returns {ds: [B,
        n_step_output, E, G, V_model_out]}."""
        graph = self.graph
        levels = self.hidden_names
        deepest = len(levels) - 1
        datasets = sorted(x)
        some = x[datasets[0]]
        batch, n_time, ens = some.shape[:3]
        if n_time != self.n_step_input:
            raise ValueError(f"Expected {self.n_step_input} input steps, got {n_time}")
        bflat = batch * ens
        dt = some.dtype

        # encode data -> h_1
        x_h = self._attrs(levels[0], bflat, dt)
        x_skip, x_data_latent, latents = {}, {}, []
        for ds in datasets:
            xd = x[ds]
            x_skip[ds] = self.residual[ds](xd, n_step_output=self.n_step_output)
            flat = xd.permute(0, 2, 3, 1, 4).reshape(bflat, xd.shape[3], n_time * xd.shape[4])
            x_in = torch.cat([flat, self._attrs(ds, bflat, dt)], dim=-1)
            sub = graph.encoder[ds]
            x_data_latent[ds], x_latent = self.encoder[ds](
                (x_in, x_h), sub, self._edges("encoder_graph_provider", sub, ds))
            latents.append(x_latent)
        state = sum(latents)

        # down: the level's processor, then the down mapper
        down_states = {}
        for i, name in enumerate(levels):
            if i == deepest and hasattr(self, "processor"):
                proc = self._process(self.processor, state, name, "processor_graph_provider",
                                     cond)
                state = proc + state if self.latent_skip else proc
            elif name in self.down_level_processor:
                state = self._process(self.down_level_processor[name], state, name,
                                      "down_level_processor_graph_providers", cond)
            down_states[name] = state
            if i < deepest:
                sub = graph.down[name]
                _, state = self.downscale[name](
                    (state, self._attrs(levels[i + 1], bflat, dt)), sub,
                    self._edges("downscale_graph_providers", sub, name))

        # up: the up mapper, the skip across the V, the level's processor
        for i in range(deepest - 1, -1, -1):
            name, nxt = levels[i], levels[i + 1]
            sub = graph.up[nxt]
            state = self.upscale[nxt]((state, down_states[name]), sub,
                                      self._edges("upscale_graph_providers", sub, nxt))
            state = state + down_states[name]
            if name in self.up_level_processor:
                state = self._process(self.up_level_processor[name], state, name,
                                      "up_level_processor_graph_providers", cond)

        # decode h_1 -> data
        out = {}
        for ds in datasets:
            idx = self.data_indices[ds]
            sub = graph.decoder[ds]
            x_out = self.decoder[ds]((state, x_data_latent[ds]), sub,
                                     self._edges("decoder_graph_provider", sub, ds))
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


class AnemoiModelHierarchicalAutoEncoder(AnemoiModelEncProcDecHierarchical):
    """The hierarchical autoencoder: the same V-cycle, which its preset
    configures with ``NoResidualConnection`` and one input step (the JAX
    package's subclass has no code of its own either)."""
