"""Weights from the JAX package into the port.

``state_dict_from_jax(params)`` takes the flax parameter tree of an
``AnemoiModelEncProcDec`` or of one of its subclasses (ensemble, autoencoder,
transport; GraphTransformer, Transformer, GNN or point-wise components) as
nested dicts of numpy arrays and returns the port's ``state_dict`` (anemoi-core names, ``model.``
prefixed, as the interface holds the model), ready for
``AnemoiModelInterface.load_state_dict(..., strict=True)``.

The port's own copy of the GraphTransformer part of the name mapping in
``anemoi_tpu/models/port.py`` (``_ref_name``):
- flax ``Dense.kernel [in, out]``       -> ``Linear.weight [out, in]`` (transposed)
- flax ``LayerNorm ln.scale / ln.bias`` -> ``LayerNorm.weight / .bias``
- flax MLP ``ffn_in / ffn_<i> / linear_out / norm`` -> ``mlp.0 / mlp.<2(i+1)> /
  mlp.<2(1+n)> / layer_norm`` with n the MLP's ``ffn_<i>`` count (a gated layer
  keeps its ``gate_proj`` / ``value_proj`` under its index)
- the scanned processor stack (leading layer axis) -> ``processor.proc.<i>``;
  with ``scan_unroll`` u its ``block_<j>`` at scan step k is layer ``k * u + j``
- a ``ConditionalLayerNorm``'s ``scale`` / ``bias`` Dense -> ``<norm>.scale`` /
  ``<norm>.bias`` Linear; the RMS qk-norm ``q_norm/rms/rms.scale`` -> ``q_norm.weight``
- the ensemble's ``NoiseConditioning_0`` / ``NoiseInjector_0`` -> ``noise_injector``
  (``noise_mlp`` an MLP, ``projection`` a Linear)
- a learnable residual ``residual_<ds>.weight`` -> ``residual.<ds>.weight``
- ``node_attributes_<name>.trainable``  -> ``node_attributes.trainable_tensors.<name>.trainable``
- a transport model's ``noise_cond_mlp_linear<k>`` -> ``noise_cond_mlp.linear<k>_no_gradscaling``
- ``trainable_edges`` of a component    -> ``<component>_graph_provider[.<ds>].trainable``
- the i-th encoder/decoder module       -> ``encoder.<ds>`` of the i-th dataset in sorted order
- the hierarchical model's ``encoder_<ds>``, ``proc_down_<h>``, ``down_<h>``,
  ``processor``, ``up_<h>``, ``proc_up_<h>``, ``decoder_<ds>`` -> ``encoder.<ds>``,
  ``down_level_processor.<h>``, ``downscale.<h>``, ``processor``, ``upscale.<h>``,
  ``up_level_processor.<h>``, ``decoder.<ds>``, their trainable edges on
  ``<module>_graph_provider(s).<key>`` (``processor_graph_provider``)
- a ``SpectralOrnsteinConnection``'s ``residual_<ds>.theta_logit`` / ``.mu``
  -> ``residual.<ds>.theta_logit`` / ``.mu``

and of its GNN part: ``GNNForwardMapper`` / ``GNNBackwardMapper`` ->
``encoder.<ds>`` / ``decoder.<ds>``; ``GNNProcessor``'s standalone
``blocks_0`` -> ``processor.proc.0`` and its scanned ``blocks`` ->
``processor.proc.<i+1>``; the MLPs ``edge_mlp``, ``node_mlp``, ``emb_edges``,
``emb_nodes_src``, ``emb_nodes_dst``, ``node_data_extractor`` as above (the
``_DecomposedEdgeMLP``'s ``ffn_in`` is laid out as an MLP's); the block's
``conv`` keeps its name.

The point-wise components, for which the JAX export keeps the flax module
names (``PointWiseMLPProcessor_0``, ``PointWiseForwardMapper_0``, the blocks'
LayerNorm ``norm.ln``), take anemoi-core's component layout instead:
``encoder.<ds>`` / ``decoder.<ds>`` (``mlp`` an MLP), ``processor.proc.<i>``
with the block's own names ``linear_in``, ``norm`` (a LayerNorm),
``linear_out``.

And of its dense ``TransformerProcessor`` part (``keep_attention`` there):
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
_MLPS = ("node_dst_mlp", "node_src_mlp", "edge_pre_mlp", "mlp", "noise_mlp", "edge_mlp",
         "node_mlp", "emb_edges", "emb_nodes_src", "emb_nodes_dst", "node_data_extractor")
_INJECTORS = ("NoiseConditioning", "NoiseInjector", "NoOpNoiseInjector")
# the hierarchical model's explicit module names: prefix -> (anemoi-core
# module, its graph provider); the longer prefixes first, so that
# ``proc_down_<h>`` never reads as ``down_``
_HIERARCHICAL = (
    ("proc_down_", "down_level_processor", "down_level_processor_graph_providers"),
    ("proc_up_", "up_level_processor", "up_level_processor_graph_providers"),
    ("encoder_", "encoder", "encoder_graph_provider"),
    ("decoder_", "decoder", "decoder_graph_provider"),
    ("down_", "downscale", "downscale_graph_providers"),
    ("up_", "upscale", "upscale_graph_providers"),
)


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
                      ("GraphTransformerBackwardMapper", "decoder"),
                      ("GNNForwardMapper", "encoder"), ("GNNBackwardMapper", "decoder"),
                      ("PointWiseForwardMapper", "encoder"),
                      ("PointWiseBackwardMapper", "decoder")):
        if p.startswith(cls):
            ds = datasets[int(p.rsplit("_", 1)[1]) if "_" in p else 0]
            return [part, ds], [f"{part}_graph_provider", ds]
    if p.startswith(("GraphTransformerProcessor", "TransformerProcessor", "GNNProcessor",
                     "PointWiseMLPProcessor")):
        return ["processor"], ["processor_graph_provider"]
    if p.split("_")[0] in _INJECTORS:
        return ["noise_injector"], []
    if p.startswith("residual_"):
        return ["residual", p[len("residual_"):]], []
    if p == "processor":  # the hierarchical model's deepest level
        return ["processor"], ["processor_graph_provider"]
    for prefix, module, provider in _HIERARCHICAL:
        if p.startswith(prefix):
            key = p[len(prefix):]
            return [module, key], [provider, key]
    return None


def _extra_layers(flat, parent: Tuple[str, ...]) -> int:
    """The ``ffn_<i>`` layers of the flax MLP at ``parent``."""
    n = len(parent)
    return len({p[n] for p in flat if p[:n] == parent and p[n].startswith("ffn_")
                and p[n][len("ffn_"):].isdigit()})


def _name(path: Tuple[str, ...], datasets: Sequence[str], flat,
          layer_0_alone: bool = False) -> Tuple[str, int, int]:
    """Map one flax parameter path to the port's state-dict name; a scanned
    processor layer index is left as ``{layer}``.  Also returns the block's
    place ``j`` inside a scan step of ``scan_unroll`` blocks (``block_<j>``;
    0 for a scan of one block) and the index of the scan's first layer (1
    for the GNN, whose layer 0 stands alone)."""
    out: List[str] = ["model"]
    provider: List[str] = []
    keep_attention = path[0].startswith("TransformerProcessor")  # the dense block
    first = int(layer_0_alone)
    sub = 0
    i = 0
    while i < len(path) - 1:
        p = path[i]
        comp = _component(p, datasets) if i == 0 else None
        if p.startswith("node_attributes_"):
            out += ["node_attributes", "trainable_tensors", p[len("node_attributes_"):]]
        elif i == 0 and p.startswith("noise_cond_mlp_"):
            out += ["noise_cond_mlp", p[len("noise_cond_mlp_"):] + "_no_gradscaling"]
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
        elif p in _MLPS and (path[i + 1] in ("ffn_in", "linear_out", "norm")
                             or path[i + 1].startswith("ffn_")):
            nxt = path[i + 1]
            if nxt == "norm":
                out += [p, "layer_norm"]
            elif nxt == "linear_out":
                out += [p, "mlp", str(2 * (1 + _extra_layers(flat, path[:i + 1])))]
            else:  # ffn_in -> mlp.0, ffn_<j> -> mlp.<2(j+1)>
                index = 0 if nxt == "ffn_in" else 2 * (int(nxt[len("ffn_"):]) + 1)
                out += [p, "mlp", str(index)]
            # skip a hidden layer's inner "linear" (a gated one keeps gate_proj / value_proj)
            i += 2 if nxt.startswith("ffn_") and path[i + 2] == "linear" else 1
        elif p == "extractor":
            out += ["node_data_extractor", "1"]
        else:
            out.append(p)
        i += 1
    leaf = {"kernel": "weight", "scale": "weight"}.get(path[-1], path[-1])
    return ".".join(out + [leaf]), sub, first


def state_dict_from_jax(params, dataset_names: Sequence[str] = ("data",)) -> Dict[str, torch.Tensor]:
    """flax params (``{"params": ...}`` or the bare tree) -> the port's
    state dict.  ``dataset_names``: the model's datasets, sorted as the JAX
    model loops over them."""
    tree = params.get("params", params)
    datasets = sorted(dataset_names)
    out: Dict[str, torch.Tensor] = {}
    flat = _flatten(tree)
    # a GNN processor's layer 0 stands alone (``blocks_0``) beside its scan
    layer_0_alone = {p[0] for p in flat if p[1:2] == ("blocks_0",)}
    names = {path: _name(path, datasets, flat, path[0] in layer_0_alone) for path in flat}
    unroll = 1 + max((sub for _, sub, _ in names.values()), default=0)  # blocks a scan step
    for path, value in flat.items():
        if path[-1] == "kernel" and value.ndim >= 2:
            value = np.swapaxes(value, -1, -2)  # [.., in, out] -> [.., out, in]
        name, sub, first = names[path]
        parts = {name: value}
        if ".qkv." in name:  # [.., 3HD, C] or [.., 3HD] -> lin_q, lin_k, lin_v
            axis = -2 if path[-1] == "kernel" else -1
            parts = {name.replace(".qkv.", f".lin_{x}."): y
                     for x, y in zip("qkv", np.split(value, 3, axis=axis))}
        for name, value in parts.items():
            if "{layer}" in name:
                for step in range(value.shape[0]):
                    layer = first + step * unroll + sub
                    out[name.replace("{layer}", str(layer))] = torch.tensor(value[step])
            else:
                out[name] = torch.tensor(value)
    return out
