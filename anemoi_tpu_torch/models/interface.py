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

The ensemble model (``AnemoiEnsModelEncProcDec``) draws its noise through
:meth:`AnemoiModelInterface.apply` from an explicit ``torch.Generator``
(default: ``context_generator("noise")``, as the JAX ``apply`` defaults to
``context_key("noise")``); ``predict_step`` serves it, one forecast step for
every member of the batch's ensemble dim.
"""

from __future__ import annotations

from typing import Dict, Optional

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
from anemoi_tpu_torch.models.graph import build_model_graph
from anemoi_tpu_torch.models.layers.attention import MultiHeadSelfAttention
from anemoi_tpu_torch.models.layers import ensemble
from anemoi_tpu_torch.models.layers.graph_blocks import GraphTransformerBaseBlock
from anemoi_tpu_torch.models.layers.normalization import ConditionalLayerNorm, LayerNorm, RMSNorm
from anemoi_tpu_torch.models.layers.residual import ScalarOrnsteinConnection
from anemoi_tpu_torch.preprocessing.processors import Processors, build_processors
from anemoi_tpu_torch.utils.device import resolve_device
from anemoi_tpu_torch.utils.seeding import context_generator

# flax's truncated_normal variance scaling: the standard deviation of a
# normal truncated at +-2 standard deviations is this fraction of the
# untruncated one, so the draws are divided by it to keep the variance
_TRUNCATED_STD = 0.87962566103423978


@torch.no_grad()
def initialise_parameters(model: nn.Module, generator: torch.Generator,
                          zero_extractor: bool = False) -> None:
    """Every parameter from its flax initialiser: ``Linear`` weights from
    ``lecun_normal`` (variance ``1 / fan_in``, truncated at two standard
    deviations) and zero biases; LayerNorm and RMSNorm scales 1 and offsets
    0; the trainable node and edge tensors 0; each decoder's output ``Linear``
    (its ``output_linear``) 0 with ``initialise_data_extractor_zero``;
    the ``scale`` and ``bias`` Linears of a ``ConditionalLayerNorm`` 0 (so
    every ensemble member starts equal); a ``ScalarOrnsteinConnection``'s
    weight its theta logits over zeros.  Draws come from ``generator`` in
    module order, on the parameters' device (the CPU when the interface
    builds its model)."""
    covered = set()
    zero = {id(dec.output_linear.weight) for dec in getattr(model, "decoder", {}).values()
            if zero_extractor}
    for module in model.modules():
        if isinstance(module, ConditionalLayerNorm):
            module.zero_()
            covered.update(id(p) for p in module.parameters())
        elif isinstance(module, ScalarOrnsteinConnection):
            module.reset_parameters()
            covered.add(id(module.weight))
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
          "AnemoiEnsModelEncProcDec": AnemoiEnsModelEncProcDec}
PRECISIONS = {"bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "16-mixed": torch.bfloat16,
              "fp32": torch.float32, "float32": torch.float32, "32": torch.float32}


class AnemoiModelInterface(nn.Module):
    """The model with its pre/post processors, on one device."""

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
    ) -> None:
        super().__init__()
        self.device = resolve_device(device)
        self.config = config
        self.metadata = metadata or {}
        self.data_indices = data_indices

        model_cfg = dict(config["model"])
        name = model_cfg.pop("name", "AnemoiModelEncProcDec")
        if name not in MODELS:
            raise NotImplementedError(f"model '{name}' is not ported to anemoi_tpu_torch")
        if model_cfg.get("hidden_names"):
            raise NotImplementedError("hierarchical models are not ported to anemoi_tpu_torch")
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
        )
        model = MODELS[name](graph=self.model_graph, data_indices=data_indices, config=model_cfg,
                             statistics=statistics)
        initialise_parameters(
            model, context_generator("model-init"),
            zero_extractor=bool((model_cfg.get("decoder") or {}).get(
                "initialise_data_extractor_zero", False)),
        )
        self.model = model.to(device=self.device, dtype=self.param_dtype)
        processors_cfg = (config.get("data") or {}).get("processors")
        self.pre_processors: Dict[str, Processors] = {
            ds: build_processors(processors_cfg, idx, statistics[ds], device=self.device)
            for ds, idx in data_indices.items()
        }
        self._input_full = {
            ds: torch.as_tensor(idx.data.input.full, dtype=torch.long, device=self.device)
            for ds, idx in data_indices.items()
        }
        self.eval()

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
        ``noise``, ``fcstep``) go to the model's forward."""
        if params is None:
            return self.model(x, **kwargs)
        return torch.func.functional_call(self.model, params, (x,), kwargs)

    @property
    def draws_noise(self) -> bool:
        """Whether the model injects noise (an ensemble model that draws)."""
        injector = self.model.noise_injector
        return injector is not None and injector.draws_noise

    def require_deterministic(self, what: str) -> None:
        """Raise ``ValueError`` if the model draws noise: ``what`` (a
        deterministic rollout) has no noise stream, as in the JAX package."""
        if self.draws_noise:
            raise ValueError(
                f"{what} cannot run a model that injects noise "
                f"({type(self.model.noise_injector).__name__}): the JAX package's runs it "
                "with no noise stream and fails; serve an ensemble with "
                "AnemoiModelInterface.predict_step (or apply), which draws the noise")

    def draw_noise(self, x: Dict[str, torch.Tensor], generator: torch.Generator) -> torch.Tensor:
        """The standard normal draw of a noise-drawing model for inputs ``x``,
        from ``generator`` (on the interface's device)."""
        return ensemble.standard_normal(self.model.noise_shape(x), generator)

    def apply(self, x: Dict[str, torch.Tensor], cond: Optional[torch.Tensor] = None,
              generator: Optional[torch.Generator] = None,
              params: Optional[Dict[str, torch.Tensor]] = None):
        """The model's forward (the JAX ``apply``), its noise drawn from
        ``generator`` or, without one, from ``context_generator("noise")``."""
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
        :meth:`apply` draws it."""
        m = self.model.n_step_input
        _, x = self.normalised_input({ds: b[:, :m] for ds, b in batch.items()})
        cast = self.param_dtype != self.inference_dtype
        y = self.apply(x, generator=generator,
                       params=self.cast_parameters(self.inference_dtype) if cast else None)
        return {ds: self.pre_processors[ds].inverse_transform(y[ds].float()) for ds in y}
