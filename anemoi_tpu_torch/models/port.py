"""Weights from the JAX package into the port.

``state_dict_from_jax(params)`` takes the flax parameter tree of a
GraphTransformer ``AnemoiModelEncProcDec`` as nested dicts of numpy arrays
and returns the port's ``state_dict`` (anemoi-core names, ``model.``
prefixed, as the interface holds the model), ready for
``AnemoiModelInterface.load_state_dict(..., strict=True)``.

The port's own copy of the GraphTransformer part of the name mapping in
``anemoi_tpu/models/port.py`` (``_ref_name``):
- flax ``Dense.kernel [in, out]``       -> ``Linear.weight [out, in]`` (transposed)
- flax ``LayerNorm ln.scale / ln.bias`` -> ``LayerNorm.weight / .bias``
- flax MLP ``ffn_in / linear_out``      -> ``mlp.0 / mlp.2`` (a gated ``ffn_in``
  keeps its ``gate_proj`` / ``value_proj`` under ``mlp.0``)
- the scanned processor stack (leading layer axis) -> ``processor.proc.<i>``;
  with ``scan_unroll`` u its ``block_<j>`` at scan step k is layer ``k * u + j``
- a ``ConditionalLayerNorm``'s ``scale`` / ``bias`` Dense -> ``<norm>.scale`` /
  ``<norm>.bias`` Linear; the RMS qk-norm ``q_norm/rms/rms.scale`` -> ``q_norm.weight``
- the ensemble's ``NoiseConditioning_0`` / ``NoiseInjector_0`` -> ``noise_injector``
  (``noise_mlp`` an MLP, ``projection`` a Linear)
- a learnable residual ``residual_<ds>.weight`` -> ``residual.<ds>.weight``
- ``node_attributes_<name>.trainable``  -> ``node_attributes.trainable_tensors.<name>.trainable``
- ``trainable_edges`` of a component    -> ``<component>_graph_provider[.<ds>].trainable``
- the i-th encoder/decoder module       -> ``encoder.<ds>`` of the i-th dataset in sorted order

and of its dense ``TransformerProcessor`` part (``keep_attention`` there):
the block keeps its ``attention`` submodule, flax's fused ``qkv`` kernel
``[C, 3HD]`` becomes the separate ``lin_q``, ``lin_k``, ``lin_v`` weights
``[HD, C]`` (anemoi-core's names; the JAX export synthesises ``qkv`` from
them), ``out_proj`` becomes ``projection``, and ``layer_norm_mlp`` keeps its
name (the GraphTransformer blocks call it ``layer_norm_mlp_dst``).
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

_NORMS = {
    "layer_norm_attention": "layer_norm_attention",
    "layer_norm_attention_src": "layer_norm_attention_src",
    "layer_norm_attention_dst": "layer_norm_attention_dest",
    "layer_norm_mlp": "layer_norm_mlp_dst",
    "layer_norm_mlp_dst": "layer_norm_mlp_dst",
    "extractor_norm": "node_data_extractor.0",
    "q_norm": "q_norm",
    "k_norm": "k_norm",
}
_MLPS = ("node_dst_mlp", "node_src_mlp", "edge_pre_mlp", "mlp", "noise_mlp")
_INJECTORS = ("NoiseConditioning", "NoiseInjector", "NoOpNoiseInjector")


def _flatten(tree, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    flat = {}
    for k, v in tree.items():
        if isinstance(v, Mapping):
            flat.update(_flatten(v, prefix + (str(k),)))
        else:
            flat[prefix + (str(k),)] = np.asarray(v)
    return flat


def _component(p: str, datasets: Sequence[str]):
    """flax module name of a top-level component -> (name parts, provider parts)."""
    for cls, part in (("GraphTransformerForwardMapper", "encoder"),
                      ("GraphTransformerBackwardMapper", "decoder")):
        if p.startswith(cls):
            ds = datasets[int(p.rsplit("_", 1)[1]) if "_" in p else 0]
            return [part, ds], [f"{part}_graph_provider", ds]
    if p.startswith("GraphTransformerProcessor") or p.startswith("TransformerProcessor"):
        return ["processor"], ["processor_graph_provider"]
    if p.split("_")[0] in _INJECTORS:
        return ["noise_injector"], []
    if p.startswith("residual_"):
        return ["residual", p[len("residual_"):]], []
    return None


def _name(path: Tuple[str, ...], datasets: Sequence[str]) -> Tuple[str, int]:
    """Map one flax parameter path to the port's state-dict name; a scanned
    processor layer index is left as ``{layer}``.  Also returns the block's
    place ``j`` inside a scan step of ``scan_unroll`` blocks (``block_<j>``;
    0 for a scan of one block)."""
    out: List[str] = ["model"]
    provider: List[str] = []
    keep_attention = path[0].startswith("TransformerProcessor")  # the dense block
    sub = 0
    i = 0
    while i < len(path) - 1:
        p = path[i]
        comp = _component(p, datasets) if i == 0 else None
        if p.startswith("node_attributes_"):
            out += ["node_attributes", "trainable_tensors", p[len("node_attributes_"):]]
        elif comp is not None:
            parts, provider = comp
            out += parts
        elif p == "trainable_edges":
            out = ["model"] + provider
        elif p == "blocks":
            out += ["proc", "{layer}"]
        elif p.startswith("blocks_") and p[len("blocks_"):].isdigit():
            out += ["proc", p[len("blocks_"):]]
        elif p == "attention" and keep_attention:
            out.append(p)
        elif p.startswith("block_") and p[len("block_"):].isdigit():
            sub = int(p[len("block_"):])  # the j-th block of an unrolled scan step
        elif p in ("block", "attention", "ln", "rms"):
            pass  # scan body, the inlined attention module, the norms' inner modules
        elif p == "out_proj":
            out.append("projection")
        elif p == "layer_norm_mlp" and keep_attention:
            out.append(p)
        elif p in _NORMS:
            out += _NORMS[p].split(".")
        elif p in _MLPS and path[i + 1] in ("ffn_in", "linear_out", "norm"):
            out += [p] + {"ffn_in": ["mlp", "0"], "linear_out": ["mlp", "2"],
                          "norm": ["layer_norm"]}[path[i + 1]]
            # skip ffn_in's inner "linear" (a gated layer keeps gate_proj / value_proj)
            i += 2 if path[i + 1] == "ffn_in" and path[i + 2] == "linear" else 1
        elif p == "extractor":
            out += ["node_data_extractor", "1"]
        else:
            out.append(p)
        i += 1
    leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
    return ".".join(out + [leaf]), sub


def state_dict_from_jax(params, dataset_names: Sequence[str] = ("data",)) -> Dict[str, torch.Tensor]:
    """flax params (``{"params": ...}`` or the bare tree) -> the port's
    state dict.  ``dataset_names``: the model's datasets, sorted as the JAX
    model loops over them."""
    tree = params.get("params", params)
    datasets = sorted(dataset_names)
    out: Dict[str, torch.Tensor] = {}
    flat = _flatten(tree)
    names = {path: _name(path, datasets) for path in flat}
    unroll = 1 + max((sub for _, sub in names.values()), default=0)  # blocks a scan step
    for path, value in flat.items():
        if path[-1] == "kernel" and value.ndim >= 2:
            value = np.swapaxes(value, -1, -2)  # [.., in, out] -> [.., out, in]
        name, sub = names[path]
        parts = {name: value}
        if ".qkv." in name:  # [.., 3HD, C] or [.., 3HD] -> lin_q, lin_k, lin_v
            axis = -2 if path[-1] == "kernel" else -1
            parts = {name.replace(".qkv.", f".lin_{x}."): y
                     for x, y in zip("qkv", np.split(value, 3, axis=axis))}
        for name, value in parts.items():
            if "{layer}" in name:
                for step in range(value.shape[0]):
                    out[name.replace("{layer}", str(step * unroll + sub))] = torch.tensor(
                        value[step])
            else:
                out[name] = torch.tensor(value)
    return out
