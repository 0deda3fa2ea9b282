"""Plain PyTorch reference of the encoder-processor-decoder weather model.

Written from the model's equations (anemoi-core's ``AnemoiModelEncProcDec``
with GraphTransformer mappers and a GraphTransformer or sliding-window
Transformer processor), in float32 with TF32 off, with no kernel, cache or
batching of the program under test.  It imports nothing of that program:
it takes the benchmark's inputs (the node coordinates and the edges'
endpoints, the weights by name, the statistics, the variable roles) and
works out everything else itself: the node features, the edge features
and the loss's area weights from the recipe, the normalisation, the
softmax over each destination's edges, the band, the residual, the
rollout.

``Precision`` says how the operands of every matrix product are rounded:
``"fp32"`` not at all (the reference), ``"fp8"`` to float8 e4m3 with one
scale a tensor (the control: the step below the program's bf16), as are
the model's input state and its output state, which the program holds in
its compute type.  The rounding is straight-through, so gradients flow in
float32.

Parameter names follow anemoi-core's module layout, which is also how the
benchmark hands weights to the program.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

LN_EPS = 1e-5
FP8_MAX = 448.0  # largest finite float8 e4m3fn


@dataclass(frozen=True)
class Precision:
    name: str = "fp32"

    def round(self, t: torch.Tensor) -> torch.Tensor:
        if self.name == "fp32":
            return t
        if self.name != "fp8":
            raise ValueError(f"unknown precision {self.name}")
        with torch.no_grad():
            scale = FP8_MAX / t.detach().abs().amax().clamp_min(1e-30)
            q = (t.detach() * scale).to(torch.float8_e4m3fn).to(torch.float32) / scale
        return t + (q - t).detach()


@dataclass
class Variables:
    """Variable roles of one dataset, in dataset order."""

    names: List[str]
    forcing: List[str]
    diagnostic: List[str]

    @property
    def input_idx(self) -> List[int]:  # model inputs: forcing and prognostic
        return [i for i, n in enumerate(self.names) if n not in self.diagnostic]

    @property
    def output_idx(self) -> List[int]:  # model outputs: prognostic and diagnostic
        return [i for i, n in enumerate(self.names) if n not in self.forcing]


def parameter_shapes(cfg: dict, num_nodes: Dict[str, int], n_vars_in: int, n_vars_out: int,
                     edge_dim: int) -> Dict[str, tuple]:
    """Every parameter's name and shape for the model ``cfg`` (the ``model``
    section) on a graph of ``num_nodes`` ({"data": G, "hidden": N})."""
    c = int(cfg["num_channels"])
    m = int(cfg["n_step_input"])
    tr = cfg.get("trainable_parameters") or {}
    hidden = int(c * float(cfg["encoder"]["mlp_hidden_ratio"]))
    attr_d, attr_h = 4 + int(tr.get("data", 0)), 4 + int(tr.get("hidden", 0))
    in_data = m * n_vars_in + attr_d
    shapes: Dict[str, tuple] = {}

    def lin(name, n_in, n_out, bias=True):
        shapes[f"{name}.weight"] = (n_out, n_in)
        if bias:
            shapes[f"{name}.bias"] = (n_out,)

    def ln(name, n):
        shapes[f"{name}.weight"] = (n,)
        shapes[f"{name}.bias"] = (n,)

    def gt_block(p, norms):
        for k in ("lin_key", "lin_query", "lin_value", "lin_self"):
            lin(f"{p}.{k}", c, c)
        lin(f"{p}.lin_edge", edge_dim, c)
        lin(f"{p}.projection", c, c)
        lin(f"{p}.node_dst_mlp.mlp.0", c, hidden)
        lin(f"{p}.node_dst_mlp.mlp.2", hidden, c)
        for n in norms:
            ln(f"{p}.{n}", c)

    for name, n in (("data", num_nodes["data"]), ("hidden", num_nodes["hidden"])):
        if int(tr.get(name, 0)):
            shapes[f"node_attributes.trainable_tensors.{name}.trainable"] = (n, int(tr[name]))
    lin("encoder.data.emb_nodes_src", in_data, c)
    lin("encoder.data.emb_nodes_dst", attr_h, c)
    gt_block("encoder.data.proc", ("layer_norm_attention_src", "layer_norm_attention_dest",
                                   "layer_norm_mlp_dst"))
    proc = cfg["processor"]
    for i in range(int(proc["num_layers"])):
        p = f"processor.proc.{i}"
        if proc["name"] == "GraphTransformerProcessor":
            gt_block(p, ("layer_norm_attention", "layer_norm_mlp_dst"))
        elif proc["name"] == "TransformerProcessor":
            ln(f"{p}.layer_norm_attention", c)
            for k in ("lin_q", "lin_k", "lin_v"):
                lin(f"{p}.attention.{k}", c, c, bias=False)
            lin(f"{p}.attention.projection", c, c)
            ln(f"{p}.layer_norm_mlp", c)
            lin(f"{p}.mlp.mlp.0", c, hidden)
            lin(f"{p}.mlp.mlp.2", hidden, c)
        else:
            raise ValueError(f"no reference for processor {proc['name']}")
    lin("decoder.data.emb_nodes_dst", in_data, c)
    gt_block("decoder.data.proc", ("layer_norm_attention_src", "layer_norm_attention_dest",
                                   "layer_norm_mlp_dst"))
    ln("decoder.data.node_data_extractor.0", c)
    lin("decoder.data.node_data_extractor.1", c, n_vars_out)
    return shapes


def sincos(coords: torch.Tensor) -> torch.Tensor:
    """(lat, lon) radians -> (sin lat, sin lon, cos lat, cos lon)."""
    return torch.cat([torch.sin(coords), torch.cos(coords)], dim=-1)


def segment_attention(q, k, v, e, src, dst, n_dst, heads):
    """Each destination attends over its incoming edges; the edge feature
    ``e`` is added to the source's key and value.  q [B, Nd, C], k and v [B,
    Ns, C], e [E, C]; src, dst [E] long."""
    b, _, c = q.shape
    d = c // heads
    ke = (k[:, src] + e).view(b, -1, heads, d)
    ve = (v[:, src] + e).view(b, -1, heads, d)
    score = (q[:, dst].view(b, -1, heads, d) * ke).sum(-1) / math.sqrt(d)  # [B, E, H]
    index = dst.view(1, -1, 1).expand_as(score)
    top = torch.full((b, n_dst, heads), -torch.inf, dtype=score.dtype, device=score.device)
    top = top.scatter_reduce(1, index, score.detach(), "amax", include_self=True)
    w = torch.exp(score - top[:, dst])
    total = torch.zeros_like(top).index_add(1, dst, w)
    out = torch.zeros(b, n_dst, heads, d, dtype=q.dtype, device=q.device)
    out = out.index_add(1, dst, w[..., None] * ve)
    return (out / total.clamp_min(1e-30)[..., None]).reshape(b, n_dst, c)


def band_attention(q, k, v, heads, window, block=512):
    """Each position attends to the positions within ``window`` of it in the
    sequence, computed a block of queries at a time.  q, k, v [B, N, C]."""
    b, n, c = q.shape
    d = c // heads
    q, k, v = (t.view(b, n, heads, d) for t in (q, k, v))
    outs = []
    for s in range(0, n, block):
        e = min(s + block, n)
        lo, hi = max(0, s - window), min(n, e + window)
        logits = torch.einsum("bqhd,bkhd->bhqk", q[:, s:e], k[:, lo:hi]) / math.sqrt(d)
        qi = torch.arange(s, e, device=q.device)[:, None]
        ki = torch.arange(lo, hi, device=q.device)[None, :]
        logits = logits.masked_fill((qi - ki).abs() > window, -torch.inf)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, -1), v[:, lo:hi]))
    return torch.cat(outs, dim=1).reshape(b, n, c)


class Reference:
    """The model's forward pass from its weights ``w`` ({name: float32
    tensor}) on the graph ``graph``: {"coords": {set: [N, 2] (lat, lon)},
    "edges": {"encoder"|"processor"|"decoder": (src [E], dst [E], attr [E,
    F])}} as tensors on one device."""

    def __init__(self, cfg: dict, graph: dict, variables: Variables,
                 precision: Precision = Precision(), checkpoint_blocks: bool = False):
        self.cfg = cfg
        self.graph = graph
        self.vars = variables
        self.prec = precision
        self.checkpoint_blocks = checkpoint_blocks
        self.c = int(cfg["num_channels"])
        self.m = int(cfg["n_step_input"])
        self.heads = int(cfg["processor"]["num_heads"])
        self.map_heads = int(cfg["encoder"]["num_heads"])
        names = variables.names
        self.prog = [n for n in names if n not in variables.forcing and n not in variables.diagnostic]
        in_names = [names[i] for i in variables.input_idx]
        out_names = [names[i] for i in variables.output_idx]
        # output position -> input position of the same prognostic variable
        self.skip = [(out_names.index(n), in_names.index(n)) for n in self.prog]

    def lin(self, w, name, x):
        weight = self.prec.round(w[f"{name}.weight"])
        y = self.prec.round(x) @ weight.t()
        bias = w.get(f"{name}.bias")
        return y if bias is None else y + bias

    def ln(self, w, name, x):
        return F.layer_norm(x, (x.shape[-1],), w[f"{name}.weight"], w[f"{name}.bias"], LN_EPS)

    def mlp(self, w, name, x):
        return self.lin(w, f"{name}.mlp.2", F.gelu(self.lin(w, f"{name}.mlp.0", x)))

    def gt_attention(self, w, p, xs, xd, edges):
        src, dst, attr = edges
        q = self.lin(w, f"{p}.lin_query", xd)
        k = self.lin(w, f"{p}.lin_key", xs)
        v = self.lin(w, f"{p}.lin_value", xs)
        e = self.lin(w, f"{p}.lin_edge", attr)
        if self.prec.name != "fp32":
            q, k, v, e = (self.prec.round(t) for t in (q, k, v, e))
        return segment_attention(q, k, v, e, src, dst, xd.shape[1], self.map_heads
                                 if p.startswith(("encoder", "decoder")) else self.heads)

    def mapper_block(self, w, p, x_src, x_dst, edges):
        xs = self.ln(w, f"{p}.layer_norm_attention_src", x_src)
        xd = self.ln(w, f"{p}.layer_norm_attention_dest", x_dst)
        att = self.gt_attention(w, p, xs, xd, edges) + self.lin(w, f"{p}.lin_self", xd)
        out = self.lin(w, f"{p}.projection", att) + x_dst
        return self.mlp(w, f"{p}.node_dst_mlp", self.ln(w, f"{p}.layer_norm_mlp_dst", out)) + out

    def gt_processor_block(self, w, p, x, edges):
        xn = self.ln(w, f"{p}.layer_norm_attention", x)
        att = self.gt_attention(w, p, xn, xn, edges) + self.lin(w, f"{p}.lin_self", xn)
        out = self.lin(w, f"{p}.projection", att) + x
        return self.mlp(w, f"{p}.node_dst_mlp", self.ln(w, f"{p}.layer_norm_mlp_dst", out)) + out

    def transformer_block(self, w, p, x):
        xn = self.ln(w, f"{p}.layer_norm_attention", x)
        q, k, v = (self.lin(w, f"{p}.attention.lin_{n}", xn) for n in "qkv")
        if self.prec.name != "fp32":
            q, k, v = (self.prec.round(t) for t in (q, k, v))
        att = band_attention(q, k, v, self.heads, int(self.cfg["processor"]["window_size"]))
        x = x + self.lin(w, f"{p}.attention.projection", att)
        return x + self.mlp(w, f"{p}.mlp", self.ln(w, f"{p}.layer_norm_mlp", x))

    def _run(self, fn, *args):
        if self.checkpoint_blocks and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    def node_attributes(self, w, name):
        feats = sincos(self.graph["coords"][name])
        key = f"node_attributes.trainable_tensors.{name}.trainable"
        return torch.cat([feats, w[key]], dim=-1) if key in w else feats

    def forward(self, w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
        """x: normalised model inputs [B, m, G, V_in] -> normalised outputs
        [B, G, V_out] (one output step)."""
        b, m, g, v_in = x.shape
        x = self.prec.round(x)
        edges = self.graph["edges"]
        x_in = torch.cat([x.permute(0, 2, 1, 3).reshape(b, g, m * v_in),
                          self.node_attributes(w, "data").expand(b, g, -1)], dim=-1)
        h_attr = self.node_attributes(w, "hidden")
        x_src = self.lin(w, "encoder.data.emb_nodes_src", x_in)
        x_dst = self.lin(w, "encoder.data.emb_nodes_dst", h_attr).expand(b, -1, -1)
        latent = self._run(lambda s, d: self.mapper_block(w, "encoder.data.proc", s, d,
                                                          edges["encoder"]), x_src, x_dst)
        proc = self.cfg["processor"]
        h = latent
        for i in range(int(proc["num_layers"])):
            p = f"processor.proc.{i}"
            if proc["name"] == "GraphTransformerProcessor":
                h = self._run(lambda t, p=p: self.gt_processor_block(w, p, t, edges["processor"]), h)
            else:
                h = self._run(lambda t, p=p: self.transformer_block(w, p, t), h)
        if self.cfg.get("latent_skip", True):
            h = h + latent
        x_data = self.lin(w, "decoder.data.emb_nodes_dst", x_in)
        out = self._run(lambda s, d: self.mapper_block(w, "decoder.data.proc", s, d,
                                                       edges["decoder"]), h, x_data)
        out = self.lin(w, "decoder.data.node_data_extractor.1",
                       self.ln(w, "decoder.data.node_data_extractor.0", out))
        skip = torch.zeros_like(out)
        last = x[:, -1]
        for o, i in self.skip:
            skip[..., o] = last[..., i]
        return self.prec.round(out + skip)


PARTS = {"encoder": ("data", "hidden"), "processor": ("hidden", "hidden"),
         "decoder": ("hidden", "data")}
EDGE_WIDTHS = {"EdgeLength": 1, "EdgeDirection": 2}
# the normalisation each attribute takes where the recipe names none
EDGE_NORMS = {"EdgeLength": "unit-max", "EdgeDirection": "unit-std"}


def _normalised(values: np.ndarray, norm: Optional[str]) -> np.ndarray:
    """``values`` (float32) scaled over the whole set: by its largest value
    (``unit-max``) or by its standard deviation (``unit-std``)."""
    if norm in (None, "none"):
        return values
    if norm == "unit-max":
        return values / np.amax(values)
    if norm == "unit-std":
        std = np.std(values)
        return values if std == 0 else values / std
    raise ValueError(f"no reference for the norm {norm}")


def _unit_vectors(lat: np.ndarray, lon: np.ndarray) -> tuple:
    return np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)


def arc_length(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Great-circle distance in radians of arc (haversine) between (lat,
    lon) points in radians."""
    h = (np.sin((dst[:, 0] - src[:, 0]) / 2.0) ** 2
         + np.cos(src[:, 0]) * np.cos(dst[:, 0]) * np.sin((dst[:, 1] - src[:, 1]) / 2.0) ** 2)
    return 2.0 * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))


def source_in_destination_frame(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """The source's (lat, lon) after its unit vector is turned by -lon_dst
    about the polar axis, then by -lat_dst about the second axis: the
    system's ``EdgeDirection`` (it puts the destination itself at (2 lat_dst,
    0), not at the origin)."""
    lat, lon = dst[:, 0], dst[:, 1]
    x, y, z = _unit_vectors(src[:, 0], src[:, 1])
    east = np.cos(lon) * y - np.sin(lon) * x
    x1 = np.cos(lon) * x + np.sin(lon) * y
    x2 = np.cos(lat) * x1 - np.sin(lat) * z
    z2 = np.sin(lat) * x1 + np.cos(lat) * z
    r = np.clip(np.sqrt(x2 * x2 + east * east + z2 * z2), 1e-12, None)
    return np.stack([np.arcsin(np.clip(z2 / r, -1.0, 1.0)), np.arctan2(east / r, x2 / r)], -1)


def edge_attribute(spec: dict, src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """One edge attribute [E, width] (float32) of the recipe's ``spec`` for
    edges from the points ``src`` to ``dst`` ([E, 2] radians)."""
    name = spec["name"]
    if name == "EdgeLength":
        values = arc_length(src, dst)[:, None]
    elif name == "EdgeDirection":
        values = source_in_destination_frame(src, dst)
    else:
        raise ValueError(f"no reference for the edge attribute {name}")
    return _normalised(values.astype(np.float32), spec.get("norm", EDGE_NORMS[name]))


def _recipe_edges(config: dict, part: str) -> dict:
    src, dst = PARTS[part]
    return next(e for e in config["graph"]["recipe"]["edges"]
                if (e["source_name"], e["target_name"]) == (src, dst))


def edge_attribute_names(config: dict, part: str) -> List[str]:
    model = config["model"]
    return list((model.get(part) or {}).get("sub_graph_edge_attributes")
                or model["encoder"]["sub_graph_edge_attributes"])


def edge_dim(config: dict) -> int:
    """Width of the encoder's edge features, from the recipe."""
    specs = _recipe_edges(config, "encoder")["attributes"]
    return sum(EDGE_WIDTHS[specs[a]["name"]] for a in edge_attribute_names(config, "encoder"))


def edge_features(config: dict, arrays: dict) -> Dict[str, np.ndarray]:
    """Each part's edge features [E, F], worked out from the node
    coordinates and the edges' endpoints alone, in the configured order."""
    out = {}
    for part, (src_set, dst_set) in PARTS.items():
        e = arrays["edges"][part]
        src = np.asarray(arrays["coords"][src_set])[np.asarray(e["src"])]
        dst = np.asarray(arrays["coords"][dst_set])[np.asarray(e["dst"])]
        specs = _recipe_edges(config, part)["attributes"]
        out[part] = np.concatenate([edge_attribute(specs[a], src, dst)
                                    for a in edge_attribute_names(config, part)], axis=1)
    return out


def area_weights(config: dict, arrays: dict) -> np.ndarray:
    """The loss's weight of each data point [G] (float32), worked out from
    its latitude as the recipe's ``CosineLatWeightedAttribute`` states:
    (max - min) cos(lat) + min, then normalised."""
    nodes = config["graph"]["recipe"]["nodes"]["data"]["attributes"]
    spec = nodes[config["training"]["area_attribute"]]
    if spec["name"] != "CosineLatWeightedAttribute":
        raise ValueError(f"no reference for the node attribute {spec['name']}")
    lo, hi = float(spec.get("min_value", 1e-3)), float(spec.get("max_value", 1.0))
    lat = np.asarray(arrays["coords"]["data"])[:, 0]
    w = (hi - lo) * np.cos(lat) + lo
    return _normalised(w.astype(np.float32)[:, None], spec.get("norm")).reshape(-1)


def graph_tensors(config: dict, arrays: dict, device) -> dict:
    """The reference's graph on ``device``: {"coords": {set: [N, 2]},
    "edges": {part: (src [E], dst [E], features [E, F])}, "area": [G]}.  Of
    the benchmark's arrays it takes the node coordinates and the edges'
    endpoints; the edge features and the area weights it works out itself."""
    feats = edge_features(config, arrays)
    out = {"coords": {k: torch.as_tensor(np.asarray(v), dtype=torch.float32, device=device)
                      for k, v in arrays["coords"].items()}, "edges": {},
           "area": torch.as_tensor(area_weights(config, arrays), device=device)}
    for part, e in arrays["edges"].items():
        out["edges"][part] = (
            torch.as_tensor(np.asarray(e["src"]), dtype=torch.long, device=device),
            torch.as_tensor(np.asarray(e["dst"]), dtype=torch.long, device=device),
            torch.as_tensor(feats[part], device=device),
        )
    return out


def model_shape(config: dict, arrays: dict, shapes: Dict[str, tuple]):
    """The yardstick's view of the configuration: widths, node and edge
    counts, the processor."""
    from perfbench.yardstick import EdgeSet, ModelShape

    cfg = config["model"]
    n = {k: int(np.asarray(v).shape[0]) for k, v in arrays["coords"].items()}
    f = shapes["encoder.data.proc.lin_edge.weight"][1]

    def es(part):
        src_set, dst_set = PARTS[part]
        return EdgeSet(n[dst_set], n[src_set], int(len(arrays["edges"][part]["src"])), f)

    proc = cfg["processor"]
    c = int(cfg["num_channels"])
    return ModelShape(
        channels=c, mlp_hidden=int(c * float(proc["mlp_hidden_ratio"])),
        n_data=n["data"], n_hidden=n["hidden"],
        in_data=shapes["encoder.data.emb_nodes_src.weight"][1],
        in_hidden=shapes["encoder.data.emb_nodes_dst.weight"][1],
        n_out=shapes["decoder.data.node_data_extractor.1.weight"][0],
        encoder=es("encoder"), decoder=es("decoder"),
        processor=proc["name"], layers=int(proc["num_layers"]), heads=int(proc["num_heads"]),
        processor_edges=es("processor") if proc["name"] == "GraphTransformerProcessor" else None,
        window=int(proc.get("window_size") or 0))


def normalise(raw: torch.Tensor, mean: torch.Tensor, std: torch.Tensor) -> torch.Tensor:
    return (raw - mean) / std


def weighted_mse(pred: torch.Tensor, target: torch.Tensor, area: torch.Tensor) -> torch.Tensor:
    """Area-weighted mean square error over [B, G, V]: sum of w_g err^2
    over the sum of the weights of every element."""
    wgt = area.view(1, -1, 1)
    return (wgt * (pred - target) ** 2).sum() / (wgt.sum() * pred.shape[0] * pred.shape[2])


def lr_schedule(count: int, rate: float, min_rate: float, warmup: int, iterations: int) -> float:
    """Linear warmup from 0 to ``rate`` over ``warmup`` updates, then cosine
    decay to ``min_rate`` at ``iterations``; read at the update count before
    the update."""
    warmup = max(warmup, 1)
    iterations = max(iterations, warmup + 1)
    if count < warmup:
        return rate * count / warmup
    t = min(count - warmup, iterations - warmup)
    decay = 0.5 * (1.0 + math.cos(math.pi * t / (iterations - warmup)))
    alpha = min_rate / rate if rate else 0.0
    return rate * ((1.0 - alpha) * decay + alpha)


def adamw_update(w, grads, state, count, lr, b1, b2, weight_decay, eps=1e-8):
    """One AdamW update of every tensor of ``w`` in place (bias-corrected
    moments, decoupled weight decay); ``count`` is the update's number from 1."""
    with torch.no_grad():
        for name, p in w.items():
            g = grads[name]
            m, v = state.setdefault(name, (torch.zeros_like(p), torch.zeros_like(p)))
            m.mul_(b1).add_(g, alpha=1 - b1)
            v.mul_(b2).addcmul_(g, g, value=1 - b2)
            if weight_decay:
                p.mul_(1 - lr * weight_decay)
            denom = (v / (1 - b2**count)).sqrt_().add_(eps)
            p.addcdiv_(m, denom, value=-lr / (1 - b1**count))
