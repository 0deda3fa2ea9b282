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
- flax MLP ``ffn_in / linear_out``      -> ``mlp.0 / mlp.2``
- the scanned processor stack (leading layer axis) -> ``processor.proc.<i>``
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
_MLPS = ("node_dst_mlp", "node_src_mlp", "edge_pre_mlp", "mlp")


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
    return None


def _name(path: Tuple[str, ...], datasets: Sequence[str]) -> str:
    """Map one flax parameter path to the port's state-dict name; a scanned
    processor layer index is left as ``{layer}``."""
    out: List[str] = ["model"]
    provider: List[str] = []
    keep_attention = path[0].startswith("TransformerProcessor")  # the dense block
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
        elif p in ("block", "attention", "ln"):
            pass  # scan body, the inlined attention module, LayerNorm's inner module
        elif p == "out_proj":
            out.append("projection")
        elif p == "layer_norm_mlp" and keep_attention:
            out.append(p)
        elif p in _NORMS:
            out += _NORMS[p].split(".")
        elif p in _MLPS and path[i + 1] in ("ffn_in", "linear_out", "norm"):
            out += [p] + {"ffn_in": ["mlp", "0"], "linear_out": ["mlp", "2"],
                          "norm": ["layer_norm"]}[path[i + 1]]
            i += 2 if path[i + 1] == "ffn_in" else 1  # skip ffn_in's inner "linear"
        elif p == "extractor":
            out += ["node_data_extractor", "1"]
        else:
            out.append(p)
        i += 1
    leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
    return ".".join(out + [leaf])


def state_dict_from_jax(params, dataset_names: Sequence[str] = ("data",)) -> Dict[str, torch.Tensor]:
    """flax params (``{"params": ...}`` or the bare tree) -> the port's
    state dict.  ``dataset_names``: the model's datasets, sorted as the JAX
    model loops over them."""
    tree = params.get("params", params)
    datasets = sorted(dataset_names)
    out: Dict[str, torch.Tensor] = {}
    for path, value in _flatten(tree).items():
        if path[-1] == "kernel" and value.ndim >= 2:
            value = np.swapaxes(value, -1, -2)  # [.., in, out] -> [.., out, in]
        name = _name(path, datasets)
        parts = {name: value}
        if ".qkv." in name:  # [.., 3HD, C] or [.., 3HD] -> lin_q, lin_k, lin_v
            axis = -2 if path[-1] == "kernel" else -1
            parts = {name.replace(".qkv.", f".lin_{x}."): y
                     for x, y in zip("qkv", np.split(value, 3, axis=axis))}
        for name, value in parts.items():
            if "{layer}" in name:
                for layer in range(value.shape[0]):
                    out[name.replace("{layer}", str(layer))] = torch.tensor(value[layer])
            else:
                out[name] = torch.tensor(value)
    return out
