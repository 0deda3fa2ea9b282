"""The benchmark's yardstick: the published peaks of the card, the model's
operations counted from its shapes, and the least time of the attention
kernels' work.

Peaks: NVIDIA H100 SXM (the data sheet's dense rates at the full 700 W):
3.35 TB/s of HBM3 and 989.4 TFLOP/s of bf16 on the tensor cores.

The least time of a launch is the larger of its bytes at the HBM rate
(each input read once, each output written once) and its operations at the
peak of its operands' type.  The byte and operation counts of the graph
attention (forward; backward as K3 + K4 or K3 + K5) and of the band
attention (K6; K7_dq, K7_dkv) are frozen copies of the program's own
counts (its smoke script's ``attention_bound``, ``backward_bounds`` and
``window_bounds``), with the bf16 peak for their operations.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989.4e12
FP32_FLOP_PER_S = 67e12  # float32 on the CUDA cores, for float32 operands


def peak_flops(elt: int) -> float:
    return BF16_FLOP_PER_S if elt == 2 else FP32_FLOP_PER_S


def least_s(nbytes: float, flops: float, elt: int) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / peak_flops(elt))


@dataclass(frozen=True)
class EdgeSet:
    """One graph-attention edge set: destinations, sources, edges and raw
    edge features."""

    n_dst: int
    n_src: int
    n_edges: int
    n_feat: int


def gt_forward_s(s: EdgeSet, hd: int, heads: int, batch: int, elt: int) -> float:
    """K1: the attention with the edge projection fused, over ``batch``
    rows (the edges and their projection shared by the rows)."""
    edge_bytes = s.n_edges * s.n_feat * elt + s.n_feat * hd * elt + hd * elt
    nbytes = (batch * 2 * s.n_dst * hd * elt + batch * 2 * s.n_src * hd * elt + edge_bytes
              + 4 * (s.n_edges + s.n_dst + 1) + batch * 4 * s.n_dst * heads)
    return least_s(nbytes, batch * s.n_edges * hd * (7 + 2 * s.n_feat), elt)


def gt_backward_s(s: EdgeSet, hd: int, heads: int, batch: int, elt: int) -> float:
    """The attention's backward, fused projection: the lesser of the
    two-pass (K3 with its per-edge dkv, then K4) and the fused (K3 without
    dkv, then K5) least times."""
    node_in = batch * (2 * s.n_dst * hd * elt + 2 * s.n_src * hd * elt)
    stats = batch * 2 * 4 * s.n_dst * heads
    edge_in = s.n_edges * s.n_feat * elt + s.n_feat * hd * elt + hd * elt
    dkv = batch * s.n_edges * 2 * hd * elt
    k3 = (node_in + stats + edge_in + 4 * (s.n_edges + s.n_dst + 1) + batch * s.n_dst * hd * elt
          + dkv + (s.n_feat + 1) * hd * 4)
    k4 = dkv + 4 * (s.n_edges + s.n_src + 1) + batch * 2 * s.n_src * hd * elt
    k5 = (node_in + stats + edge_in + 4 * (2 * s.n_edges + s.n_src + 1)
          + batch * 2 * s.n_src * hd * elt)
    per_edge = batch * s.n_edges * hd
    k3_ops = per_edge * (12 + 4 * s.n_feat)
    two_pass = least_s(k3, k3_ops, elt) + least_s(k4, per_edge * 2, elt)
    fused = least_s(k3 - dkv, k3_ops, elt) + least_s(k5, per_edge * (12 + 2 * s.n_feat), elt)
    return min(two_pass, fused)


def band_pairs(n: int, window: int) -> int:
    """(query, key) pairs of the band |i - j| <= w per row and head."""
    w = min(int(window), n - 1)
    return n * (2 * w + 1) - w * (w + 1)


def band_forward_s(b: int, n: int, h: int, d: int, w: int, elt: int) -> float:
    """K6: reads q, k, v, writes the output and the row statistics; 4d
    operations a pair."""
    pairs, x, stats = b * h * band_pairs(n, w), b * n * h * d * elt, 4 * b * h * n
    return least_s(4 * x + stats, 4 * d * pairs, elt)


def band_backward_s(b: int, n: int, h: int, d: int, w: int, elt: int) -> float:
    """K7_dq (6d a pair) and K7_dkv (8d a pair)."""
    pairs, x, stats = b * h * band_pairs(n, w), b * n * h * d * elt, 4 * b * h * n
    return (least_s(5 * x + 2 * stats, 6 * d * pairs, elt)
            + least_s(6 * x + 2 * stats, 8 * d * pairs, elt))


@dataclass(frozen=True)
class ModelShape:
    """What the operation count of one model evaluation needs."""

    channels: int
    mlp_hidden: int
    n_data: int
    n_hidden: int
    in_data: int  # the data nodes' input width (inputs and node attributes)
    in_hidden: int  # the hidden nodes' attribute width
    n_out: int
    encoder: EdgeSet
    decoder: EdgeSet
    processor: str  # GraphTransformerProcessor or TransformerProcessor
    layers: int
    heads: int
    processor_edges: EdgeSet = None  # GraphTransformer processor
    window: int = 0  # Transformer processor

    def gt_sets(self) -> List[EdgeSet]:
        """The graph-attention sets of one evaluation, one a layer."""
        sets = [self.encoder, self.decoder]
        if self.processor == "GraphTransformerProcessor":
            sets += [self.processor_edges] * self.layers
        return sets


def forward_flops(s: ModelShape) -> float:
    """Operations of one forward evaluation of one sample: every matrix
    product (2 a multiply-add) and the attention's products (q.k and the
    weighted sum of the values, 4 a channel; the edge projection, 2F)."""
    c, hid = s.channels, s.mlp_hidden

    def dense(rows, n_in, n_out):
        return 2 * rows * n_in * n_out

    def gt_block(n_src, n_dst, e: EdgeSet):
        return (dense(n_src, c, 2 * c)  # key, value
                + dense(n_dst, c, 2 * c)  # query, self
                + dense(e.n_edges, e.n_feat, c) + 4 * e.n_edges * c
                + dense(n_dst, c, c)  # projection
                + dense(n_dst, c, hid) + dense(n_dst, hid, c))

    total = dense(s.n_data, s.in_data, c) + dense(s.n_hidden, s.in_hidden, c)
    total += gt_block(s.n_data, s.n_hidden, s.encoder)
    if s.processor == "GraphTransformerProcessor":
        total += s.layers * gt_block(s.n_hidden, s.n_hidden, s.processor_edges)
    else:
        n = s.n_hidden
        per_layer = (dense(n, c, 3 * c) + 4 * c * band_pairs(n, s.window)
                     + dense(n, c, c) + dense(n, c, hid) + dense(n, hid, c))
        total += s.layers * per_layer
    total += dense(s.n_data, s.in_data, c)  # the decoder's data-node embedding
    total += gt_block(s.n_hidden, s.n_data, s.decoder)
    total += dense(s.n_data, c, s.n_out)
    return float(total)


def training_flops(s: ModelShape) -> float:
    """A training evaluation of one sample: the forward, and twice it for the
    backward (no recompute counted)."""
    return 3.0 * forward_flops(s)
