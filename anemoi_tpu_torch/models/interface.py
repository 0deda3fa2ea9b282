"""Model interface: model + per-dataset pre/post processors + metadata.

Port of ``anemoi_tpu.models.interface.AnemoiModelInterface``.  It is an
``nn.Module`` whose ``.model`` is the ``AnemoiModelEncProcDec``, as in
anemoi-core, so reference state dicts (``model.``-prefixed names) load into
it with ``load_state_dict(..., strict=True)``.

Serving precision: ``model.inference_precision`` (default ``bf16``, the
reference's 16-mixed serving; ``fp32`` on request).  The JAX package casts
its parameters and the normalised inputs to that type on every call; here,
by default, the parameters are held in it, and a float32 state dict is cast
as it loads.  Pre- and post-processing stay float32.

Initial weights follow the JAX package's flax initialisers, drawn from a
``torch.Generator`` seeded with ``context_seed("model-init")``
(:func:`initialise_parameters`): the same distribution per tensor, not the
same draws.  Parity tests and bundles overwrite them with
``load_state_dict``.

Training (``training=True``): the parameters (the master weights) and the
graph arrays are held in float32, and each step runs the model on compute
copies cast by :meth:`AnemoiModelInterface.cast_parameters` (the JAX
``training/step.py`` ``_cast_params``); ``predict_step`` casts the same way
to the serving type.

The hierarchical V-cycle models (``AnemoiModelEncProcDecHierarchical``,
``AnemoiModelHierarchicalAutoEncoder``) get the model graph of their levels
(``hidden_names``, or the graph's ``hidden*`` sets); every level's trainable
node attributes are ``node_attributes.trainable_tensors.<level>``.

The transport models (``AnemoiTransportModelEncProcDec``,
``AnemoiTransportTendModelEncProcDec``) run through :meth:`run_model` with
the noised target and its noise level (``y_noised=``, ``noise_level=``):
``training/transport_step.py`` trains and samples them;
:meth:`require_deterministic` refuses them to the deterministic rollouts and
:meth:`apply` refuses them.

The ensemble model (``AnemoiEnsModelEncProcDec``) draws its noise through
:meth:`AnemoiModelInterface.apply` from an explicit ``torch.Generator``
(default: ``context_generator("noise")``, as the JAX ``apply`` defaults to
``context_key("noise")``); ``predict_step`` serves it, one forecast step for
every member of the batch's ensemble dim.

A variable-expanding ``Remapper`` among ``data.processors`` rewrites the
index collections and the statistics before the model and the rest of the
chain are built, so that everything downstream lives in the remapped
variable space, and it goes first in each chain.  ``predict_step`` computes
the imputer's NaN bookkeeping from the raw inputs and puts the NaNs back on
the way out; ``make_forecast_fn`` does not, as in the JAX package.

Model parallelism: an interface built with a ``mesh`` (``parallel/mesh.py``)
whose model group has ``num_model_shards`` ranks builds the model's halo
tables over it (``AnemoiModelEncProcDec.shard_over``).  Each rank then runs
the model on its grid rows (:meth:`local_rows` cuts a whole-grid batch to
them) and :meth:`gather_grid` joins the rows of the model group;
``predict_step`` takes a whole-grid or a local batch and returns the whole
grid on every rank of the model group.  Along an ensemble group
(``hardware.num_devices_per_ensemble``) ``predict_step`` forecasts the
rank's block of the batch's members, each with its one-process noise
(:meth:`AnemoiModelInterface.draw_noise`), and returns every member on
every rank of the group.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.models.encoder_processor_decoder import (
    AnemoiEnsModelEncProcDec,
    AnemoiModelAutoEncoder,
    AnemoiModelEncProcDec,
)
from anemoi_tpu_torch.models.graph import build_model_graph, infer_hidden_names
from anemoi_tpu_torch.models.hierarchical import (
    AnemoiModelEncProcDecHierarchical,
    AnemoiModelHierarchicalAutoEncoder,
)
from anemoi_tpu_torch.models.layers.attention import MultiHeadSelfAttention
from anemoi_tpu_torch.models.layers import ensemble
from anemoi_tpu_torch.models.layers.graph_blocks import GraphTransformerBaseBlock
from anemoi_tpu_torch.models.layers.normalization import ConditionalLayerNorm, LayerNorm, RMSNorm
from anemoi_tpu_torch.models.layers.residual import (
    ScalarOrnsteinConnection,
    SpectralOrnsteinConnection,
)
from anemoi_tpu_torch.models.transport_model import (
    AnemoiTransportModelEncProcDec,
    AnemoiTransportTendModelEncProcDec,
)
from anemoi_tpu_torch.preprocessing.processors import Processors, build_processors
from anemoi_tpu_torch.preprocessing.remapper import Remapper
from anemoi_tpu_torch.utils.device import resolve_device
from anemoi_tpu_torch.utils.seeding import context_generator

# flax's truncated_normal variance scaling: the standard deviation of a
# normal truncated at +-2 standard deviations is this fraction of the
# untruncated one, so the draws are divided by it to keep the variance
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def initialise_parameters(model: nn.Module, generator: torch.Generator,
                          zero_heads: Sequence[nn.Module] = ()) -> None:
    """Every parameter from its flax initialiser: ``Linear`` weights from
    ``lecun_normal`` (variance ``1 / fan_in``, truncated at two standard
    deviations) and zero biases; LayerNorm and RMSNorm scales 1 and offsets
    0; the trainable node and edge tensors 0; the output ``Linear`` (its
    ``output_linear``) of each mapper of ``zero_heads`` (those configured with
    ``initialise_data_extractor_zero``) 0;
    the ``scale`` and ``bias`` Linears of a ``ConditionalLayerNorm`` 0 (so
    every ensemble member starts equal); a ``ScalarOrnsteinConnection``'s
    weight its theta logits over zeros, a ``SpectralOrnsteinConnection``'s
    theta logits ``theta_init`` and mu 0.  Draws come from ``generator`` in
    module order, on the parameters' device (the CPU when the interface
    builds its model)."""
    covered = set()
    zero = {id(head.output_linear.weight) for head in zero_heads}
    for module in model.modules():
        if isinstance(module, ConditionalLayerNorm):
            module.zero_()
            covered.update(id(p) for p in module.parameters())
        elif isinstance(module, ScalarOrnsteinConnection):
            module.reset_parameters()
            covered.add(id(module.weight))
        elif isinstance(module, SpectralOrnsteinConnection):
            module.reset_parameters()
            covered.update(id(p) for p in module.parameters())
    for module in model.modules():
        if isinstance(module, nn.Linear) and id(module.weight) in covered:
            continue
        if isinstance(module, nn.Linear):
            std = (1.0 / module.in_features) ** 0.5 / _TRUNCATED_STD
            if id(module.weight) in zero:
                module.weight.zero_()
            else:
                nn.init.trunc_normal_(module.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
            covered.add(id(module.weight))
        elif isinstance(module, (LayerNorm, nn.LayerNorm, RMSNorm)) and module.weight is not None:
            module.weight.fill_(1.0)
            covered.add(id(module.weight))
        else:
            continue
        if getattr(module, "bias", None) is not None:
            module.bias.zero_()
            covered.add(id(module.bias))
    for name, p in model.named_parameters():
        if id(p) in covered:
            continue
        if not name.endswith(".trainable"):
            raise NotImplementedError(f"no initialiser for parameter '{name}'")
        p.zero_()


MODELS = {"AnemoiModelEncProcDec": AnemoiModelEncProcDec,
          "AnemoiModelAutoEncoder": AnemoiModelAutoEncoder,
          "AnemoiEnsModelEncProcDec": AnemoiEnsModelEncProcDec,
          "AnemoiTransportModelEncProcDec": AnemoiTransportModelEncProcDec,
          "AnemoiTransportTendModelEncProcDec": AnemoiTransportTendModelEncProcDec,
          "AnemoiModelEncProcDecHierarchical": AnemoiModelEncProcDecHierarchical,
          "AnemoiModelHierarchicalAutoEncoder": AnemoiModelHierarchicalAutoEncoder}
PRECISIONS = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "16-mixed": torch.bfloat16,
              "fp32": torch.float32, "float32": torch.float32, "32": torch.float32}


class AnemoiModelInterface(nn.Module):
    """The model with its pre/post processors, on one device.  With
    ``initialise=False`` the parameters skip :func:`initialise_parameters`
    (they keep torch's construction values), for a caller that loads every
    one of them next, as ``load_inference_checkpoint`` does."""

    def __init__(
        self,
        *,
        config: dict,
        graph: Graph,
        data_indices: Dict[str, IndexCollection],
        statistics: Dict[str, Dict[str, np.ndarray]],
        metadata: Optional[dict] = None,
        device: torch.device | str | None = None,
        training: bool = False,
        mesh=None,
        initialise: bool = True,
    ) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.mesh = mesh
        self.config = config
        self.metadata = metadata or {}
        processors_cfg = list((config.get("data") or {}).get("processors") or [])
        remap_cfg = next((dict(c) for c in processors_cfg if c.get("name") == "Remapper"), None)
        self.remappers: Dict[str, Remapper] = {}
        if remap_cfg is not None:
            remap_cfg.pop("name")
            data_indices, statistics = dict(data_indices), dict(statistics)
            for ds in data_indices:
                rm = Remapper(data_indices[ds], remap_cfg.get("config", remap_cfg),
                              device=self.device)
                self.remappers[ds] = rm
                data_indices[ds] = rm.data_indices
                statistics[ds] = rm.remap_statistics(statistics[ds])
            processors_cfg = [c for c in processors_cfg if c.get("name") != "Remapper"]
        self.data_indices = data_indices

        model_cfg = dict(config["model"])
        name = model_cfg.pop("name", "AnemoiModelEncProcDec")
        if name not in MODELS:
            raise NotImplementedError(f"model '{name}' is not ported to anemoi_tpu_torch")
        # the hidden node set the encoder and decoder map to: the hierarchy's
        # finest level, else "hidden", else the first hidden* set
        hidden_names, hidden_name = None, "hidden"
        hiddens = sorted(n for n in graph.node_names() if n.startswith("hidden"))
        if issubclass(MODELS[name], AnemoiModelEncProcDecHierarchical):
            hidden_names = list(model_cfg.get("hidden_names") or
                                infer_hidden_names(graph.node_names()))
            hidden_name = hidden_names[0]
        elif model_cfg.get("hidden_names"):
            hidden_name = model_cfg["hidden_names"][0]
        elif "hidden" not in hiddens and hiddens:
            hidden_name = hiddens[0]
        prec = str(model_cfg.get("inference_precision", "bf16"))
        if prec not in PRECISIONS:
            raise ValueError(f"unknown inference_precision '{prec}'")
        self.inference_dtype = PRECISIONS[prec]
        self.param_dtype = torch.float32 if training else self.inference_dtype

        self.model_graph = build_model_graph(
            graph,
            dataset_names=sorted(data_indices),
            device=self.device,
            dtype=self.param_dtype,
            encoder_edge_attributes=(model_cfg.get("encoder") or {}).get("sub_graph_edge_attributes"),
            processor_edge_attributes=(model_cfg.get("processor") or {}).get(
                "sub_graph_edge_attributes"
            ),
            decoder_edge_attributes=(model_cfg.get("decoder") or {}).get("sub_graph_edge_attributes"),
            hidden_name=hidden_name,
            hidden_names=hidden_names,
        )
        model = MODELS[name](graph=self.model_graph, data_indices=data_indices, config=model_cfg,
                             statistics=statistics)
        # the mappers whose output head starts at zero: the decoders and a
        # hierarchy's up mappers (built from ``up_mapper`` or the decoder's config)
        zero_heads = []
        for part, modules in (("decoder", "decoder"),
                              ("up_mapper" if "up_mapper" in model_cfg else "decoder", "upscale")):
            if (model_cfg.get(part) or {}).get("initialise_data_extractor_zero", False):
                zero_heads += list(getattr(model, modules, {}).values())
        if initialise:
            initialise_parameters(model, context_generator("model-init"), zero_heads)
        self.model = model.to(device=self.device, dtype=self.param_dtype)
        model.shard_over(mesh)
        self.pre_processors: Dict[str, Processors] = {}
        for ds, idx in data_indices.items():
            chain = build_processors(processors_cfg, idx, statistics[ds], device=self.device)
            if ds in self.remappers:
                # first: its transform takes the raw data space, its inverse runs last
                chain.processors.insert(0, self.remappers[ds])
            self.pre_processors[ds] = chain
        self._input_full = {
            ds: torch.as_tensor(idx.data.input.full, dtype=torch.long, device=self.device)
            for ds, idx in data_indices.items()
        }
        self.eval()

    @property
    def model_group(self):
        """The model group of a model-parallel interface, else None."""
        return self.mesh.group("model") if getattr(self.model, "halo", None) else None

    def local_rows(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``{ds: [B, T, E, G, V]}`` cut to this rank's grid rows where ``G``
        is the whole grid (a no-op without model shards or on local rows)."""
        if self.model_group is None:
            return batch
        out = {}
        for ds, b in batch.items():
            rows = self.model.grid_rows(ds)
            out[ds] = (b[:, :, :, rows] if b.shape[3] == self.model.graph.num_nodes[ds]
                       and b.shape[3] != rows.stop - rows.start else b)
        return out

    def gather_grid(self, y: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``{ds: [..., G_local, V]}`` (grid on dim 3) joined over the model
        group into the whole grid, on every rank of the group (a no-op
        without model shards).  Collective."""
        group = self.model_group
        if group is None:
            return y
        from anemoi_tpu_torch.parallel.distributed import all_gather

        out = {}
        for ds in sorted(y):
            block = self.model.halo["encoder"][ds].n_local_src
            pad = torch.nn.functional.pad(y[ds], (0, 0, 0, block - y[ds].shape[3]))
            whole = torch.cat(all_gather(pad, group), dim=3)
            out[ds] = whole[:, :, :, : self.model.graph.num_nodes[ds]]
        return out

    def use_plain_attention(self, plain: bool = True) -> None:
        """Run every attention -- the graph attention of the GraphTransformer
        blocks and the band of the dense Transformer's -- on its plain PyTorch
        version (``True``) or on the CUDA kernels (``False``, the default on
        the card)."""
        for module in self.modules():
            if isinstance(module, (GraphTransformerBaseBlock, MultiHeadSelfAttention)):
                module.plain_attention = plain

    def cast_parameters(self, dtype: torch.dtype, fp32_head: bool = False) -> Dict[str, torch.Tensor]:
        """Compute copies of the model's parameters, ``{name: p.to(dtype)}``
        with the names of ``self.model``.  The casts stay in the autograd
        graph, so gradients reach the float32 masters.  ``fp32_head`` keeps
        the decoder's output head (``node_data_extractor``: its LayerNorm and
        Linear) in float32, as the JAX ``fp32_head`` keeps ``extractor*``."""
        return {
            name: p if fp32_head and "node_data_extractor" in name else p.to(dtype)
            for name, p in self.model.named_parameters()
        }

    def run_model(self, x: Dict[str, torch.Tensor], params: Optional[Dict[str, torch.Tensor]] = None,
                  **kwargs):
        """The model on ``x``, with its own parameters or with ``params``
        (e.g. :meth:`cast_parameters`) in their place; ``kwargs`` (``cond``,
        ``noise``, ``fcstep``; a transport model's ``y_noised`` and
        ``noise_level``) go to the model's forward."""
        if params is None:
            return self.model(x, **kwargs)
        return torch.func.functional_call(self.model, params, (x,), kwargs)

    @property
    def draws_noise(self) -> bool:
        """Whether the model injects noise (an ensemble model that draws)."""
        injector = self.model.noise_injector
        return injector is not None and injector.draws_noise

    @property
    def is_transport(self) -> bool:
        """Whether the model is a transport (generative) model."""
        return bool(getattr(self.model, "is_transport", False))

    def require_deterministic(self, what: str) -> None:
        """Raise ``ValueError`` if the model draws noise: ``what`` (a
        deterministic rollout) has no noise stream, as in the JAX package;
        or if it is a transport model, whose forward takes a noised target
        and a noise level that a deterministic rollout does not have (the
        JAX package's fails on it)."""
        if self.is_transport:
            raise ValueError(
                f"{what} cannot run the transport model {type(self.model).__name__}: its "
                "forward takes a noised target and a noise level; sample it with "
                "training/transport_step.make_sampler or inference.make_transport_forecast_fn "
                "(`predict` serves a transport bundle)")
        if self.draws_noise:
            raise ValueError(
                f"{what} cannot run a model that injects noise "
                f"({type(self.model.noise_injector).__name__}): the JAX package's runs it "
                "with no noise stream and fails; serve an ensemble with "
                "AnemoiModelInterface.predict_step (or apply), which draws the noise")

    def draw_shard(self, ds: str, batch_sharded: bool = False):
        """Where this rank's ``[B, T, E, G, V]`` block of dataset ``ds`` lies
        in the one-process field (``models/transport/random_fields.DrawShard``:
        its data group's batch rows with ``batch_sharded``, its model group's
        grid rows), or None on one rank."""
        if self.mesh is None:
            return None
        from anemoi_tpu_torch.models.transport.random_fields import DrawShard
        from anemoi_tpu_torch.parallel.mesh import grid_block

        sizes, index = None, 0
        if self.model_group is not None:
            n, s = self.model.graph.num_nodes[ds], self.model.num_model_shards
            blocks = [grid_block(n, s, i) for i in range(s)]
            sizes, index = tuple(b.stop - b.start for b in blocks), self.mesh.index("model")
        if batch_sharded:
            return DrawShard(self.mesh.index("data"), self.mesh.size("data"), sizes, index)
        return DrawShard(0, 1, sizes, index)

    @property
    def ensemble_group(self):
        """The ensemble group of the interface's mesh, else None."""
        return None if self.mesh is None else self.mesh.group("ensemble")

    def draw_noise(self, x: Dict[str, torch.Tensor], generator: torch.Generator,
                   batch_sharded: bool = False) -> torch.Tensor:
        """The standard normal draw of a noise-drawing model for inputs ``x``,
        from ``generator`` (on the interface's device).  On a mesh the draw is
        the one-process draw of the whole ensemble (``E`` times ``x``'s
        members, the ranks of the ensemble group) and, with
        ``batch_sharded``, of the global batch (the data group's batch rows),
        cut to this rank's batch rows and members; the model cuts its hidden
        rows."""
        shape = self.model.noise_shape(x)
        mesh = self.mesh
        if mesh is None:
            return ensemble.standard_normal(shape, generator)
        from anemoi_tpu_torch.models.transport.random_fields import DrawShard, sharded_normal

        some = next(iter(x.values()))
        b, m = some.shape[0], some.shape[2]
        shard = DrawShard(mesh.index("data") if batch_sharded else 0,
                          mesh.size("data") if batch_sharded else 1,
                          member_index=mesh.index("ensemble"),
                          member_shards=mesh.size("ensemble"))
        # [B·M, N, C] drawn as [B, 1, M, N, C]: the same order of draws
        return sharded_normal(generator, (b, 1, m) + tuple(shape[1:]),
                              shard=shard).reshape(shape)

    def apply(self, x: Dict[str, torch.Tensor], cond: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              params: Optional[Dict[str, torch.Tensor]] = None):
        """The model's forward (the JAX ``apply``), its noise drawn from
        ``generator`` or, without one, from ``context_generator("noise")``."""
        if self.is_transport:
            raise ValueError("a transport model is sampled, not applied: see "
                             "training/transport_step.make_sampler")
        noise = None
        if self.draws_noise:
            noise = self.draw_noise(
                x, generator or context_generator("noise", device=self.device))
        return self.run_model(x, params, cond=cond, noise=noise)

    def normalised_input(self, batch: Dict[str, torch.Tensor]):
        """Normalise raw data-space windows (float32): returns the full
        normalised windows and the model inputs of the first
        ``n_step_input`` steps, in the serving type."""
        m = self.model.n_step_input
        batch_norm, x = {}, {}
        for ds in self.data_indices:
            batch_norm[ds] = self.pre_processors[ds].transform(batch[ds].float())
            x[ds] = batch_norm[ds][:, :m][..., self._input_full[ds]].to(self.inference_dtype)
        return batch_norm, x

    @torch.no_grad()
    def predict_step(self, batch: Dict[str, torch.Tensor],
                     generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One prediction from a raw (data-space) batch ``{ds: [B, T>=m, E,
        G, V_data]}``; returns the denormalised model-space output
        ``{ds: [B, n_step_output, E, G, V_model_out]}`` in float32.  An
        ensemble model predicts every member of ``E`` (tile the window over
        ``E`` for an ensemble from one state), its noise drawn as
        :meth:`apply` draws it.  An imputed output variable is NaN where its
        input was NaN.  Under model shards every rank of the model group
        takes part and returns the whole grid."""
        m = self.model.n_step_input
        members = self.ensemble_group
        if members is not None:
            # this rank's block of the members, gathered again after the model
            from anemoi_tpu_torch.parallel.mesh import member_block

            some = next(iter(batch.values()))
            block = member_block(some.shape[2], self.mesh.size("ensemble"),
                                 self.mesh.index("ensemble"))
            batch = {ds: b[:, :, block] for ds, b in batch.items()}
        raw = self.local_rows({ds: b[:, :m] for ds, b in batch.items()})
        aux = {ds: self.pre_processors[ds].compute_aux(raw[ds]) for ds in self.data_indices}
        _, x = self.normalised_input(raw)
        cast = self.param_dtype != self.inference_dtype
        y = self.apply(x, generator=generator,
                       params=self.cast_parameters(self.inference_dtype) if cast else None)
        y = self.gather_grid({
            ds: self.pre_processors[ds].inverse_transform(y[ds].float(), aux=aux[ds]) for ds in y})
        if members is not None:
            from anemoi_tpu_torch.training.losses.base import gather_members

            y = {ds: gather_members(v, members) for ds, v in y.items()}
        return y
