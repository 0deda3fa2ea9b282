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

Training (``training=True``): the parameters (the master weights) and the
graph arrays are held in float32, and each step runs the model on compute
copies cast by :meth:`AnemoiModelInterface.cast_parameters` (the JAX
``training/step.py`` ``_cast_params``); ``predict_step`` casts the same way
to the serving type.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from anemoi_tpu_torch.data_indices.collection import IndexCollection
from anemoi_tpu_torch.graphs.graph import Graph
from anemoi_tpu_torch.models.encoder_processor_decoder import AnemoiModelEncProcDec
from anemoi_tpu_torch.models.graph import build_model_graph
from anemoi_tpu_torch.models.layers.graph_blocks import GraphTransformerBaseBlock
from anemoi_tpu_torch.preprocessing.processors import Processors, build_processors
from anemoi_tpu_torch.utils.device import resolve_device

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
        if name != "AnemoiModelEncProcDec":
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
        self.model = AnemoiModelEncProcDec(
            graph=self.model_graph, data_indices=data_indices, config=model_cfg
        ).to(device=self.device, dtype=self.param_dtype)
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
        """Run every attention block on its plain PyTorch version (``True``)
        or on the CUDA kernel (``False``, the default on the card)."""
        for module in self.modules():
            if isinstance(module, GraphTransformerBaseBlock):
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

    def run_model(self, x: Dict[str, torch.Tensor], params: Optional[Dict[str, torch.Tensor]] = None):
        """The model on ``x``, with its own parameters or with ``params``
        (e.g. :meth:`cast_parameters`) in their place."""
        if params is None:
            return self.model(x)
        return torch.func.functional_call(self.model, params, (x,))

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
    def predict_step(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """One prediction from a raw (data-space) batch ``{ds: [B, T>=m, E,
        G, V_data]}``; returns the denormalised model-space output
        ``{ds: [B, n_step_output, E, G, V_model_out]}`` in float32."""
        m = self.model.n_step_input
        _, x = self.normalised_input({ds: b[:, :m] for ds, b in batch.items()})
        cast = self.param_dtype != self.inference_dtype
        y = self.run_model(x, self.cast_parameters(self.inference_dtype) if cast else None)
        return {ds: self.pre_processors[ds].inverse_transform(y[ds].float()) for ds in y}
