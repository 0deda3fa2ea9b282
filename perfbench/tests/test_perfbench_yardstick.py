"""The FLOP model and the frozen bound functions at small shapes, against
hand counts and against torch's FlopCounterMode on the plain reference."""

from __future__ import annotations

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from conftest import tiny_config

from perfbench import yardstick as y
from perfbench.harness.inputs import build_inputs, draw_weights, model_shape, reference_graph
from perfbench.reference.encprocdec import Reference


def test_peaks_are_the_published_h100_rates():
    assert y.HBM_BYTES_PER_S == 3.35e12 and y.BF16_FLOP_PER_S == 989.4e12
    assert y.peak_flops(2) == 989.4e12


def test_gt_forward_bound_by_hand():
    s = y.EdgeSet(n_dst=2, n_src=3, n_edges=4, n_feat=3)
    hd, heads, b, elt = 8, 2, 1, 2
    nbytes = (2 * 2 * 8 * 2 + 2 * 3 * 8 * 2  # q, out; k, v
              + 4 * 3 * 2 + 3 * 8 * 2 + 8 * 2  # raw edges, weight, bias
              + 4 * (4 + 2 + 1) + 4 * 2 * 2)  # src, dst_ptr; lse
    flops = 4 * 8 * (7 + 2 * 3)
    assert y.gt_forward_s(s, hd, heads, b, elt) == max(nbytes / 3.35e12, flops / 989.4e12)


def test_gt_backward_bound_by_hand():
    s = y.EdgeSet(n_dst=2, n_src=3, n_edges=4, n_feat=3)
    hd, heads, b, elt = 8, 2, 1, 2
    node_in = 2 * 2 * 8 * 2 + 2 * 3 * 8 * 2
    stats = 2 * 4 * 2 * 2
    edge_in = 4 * 3 * 2 + 3 * 8 * 2 + 8 * 2
    dkv = 4 * 2 * 8 * 2
    k3 = node_in + stats + edge_in + 4 * 7 + 2 * 8 * 2 + dkv + 4 * 8 * 4
    k4 = dkv + 4 * (4 + 3 + 1) + 2 * 3 * 8 * 2
    k5 = node_in + stats + edge_in + 4 * (8 + 3 + 1) + 2 * 3 * 8 * 2

    def t(nbytes, flops):
        return max(nbytes / 3.35e12, flops / 989.4e12)

    per_edge = 4 * 8
    two_pass = t(k3, per_edge * 24) + t(k4, per_edge * 2)
    fused = t(k3 - dkv, per_edge * 24) + t(k5, per_edge * 18)
    assert y.gt_backward_s(s, hd, heads, b, elt) == pytest.approx(min(two_pass, fused), rel=1e-12)


def test_band_bounds_by_hand():
    # n = 5, w = 1: pairs a row and head 5 * 3 - 2 = 13
    assert y.band_pairs(5, 1) == sum(1 for i in range(5) for j in range(5) if abs(i - j) <= 1)
    b, n, h, d, w, elt = 1, 5, 2, 4, 1, 2
    pairs, x, stats = 2 * 13, 5 * 2 * 4 * 2, 4 * 2 * 5
    assert y.band_forward_s(b, n, h, d, w, elt) == max((4 * x + stats) / 3.35e12,
                                                       4 * d * pairs / 989.4e12)
    assert y.band_backward_s(b, n, h, d, w, elt) == pytest.approx(
        max((5 * x + 2 * stats) / 3.35e12, 6 * d * pairs / 989.4e12)
        + max((6 * x + 2 * stats) / 3.35e12, 8 * d * pairs / 989.4e12))


@pytest.mark.parametrize("name", ["gt-o96-1024", "transformer-o96-1024"])
def test_flop_model_against_flop_counter(name):
    """FlopCounterMode counts the reference's matrix products: the model's
    dense terms exactly; the reference's graph attention is elementwise
    (not counted) and its band computes whole rectangles of blocks."""
    cfg = tiny_config(name)
    inputs = build_inputs(cfg, 3)
    shape = model_shape(inputs)
    ref = Reference(cfg["model"], reference_graph(inputs, "cpu"), inputs.variables)
    w = draw_weights(inputs.shapes, 3, "cpu")
    x = torch.randn(1, 2, shape.n_data, len(inputs.variables.input_idx))
    with FlopCounterMode(display=False) as counter:
        ref.forward(w, x)
    counted = counter.get_total_flops()
    c = shape.channels
    attention = sum(4 * e.n_edges * c for e in shape.gt_sets())
    expected = y.forward_flops(shape) - attention
    if shape.processor == "TransformerProcessor":
        n, win, block = shape.n_hidden, shape.window, 512
        rect = sum((min(s + block, n) - s) * (min(n, s + block + win) - max(0, s - win))
                   for s in range(0, n, block))
        expected += shape.layers * 4 * c * (rect - y.band_pairs(n, win))
    assert counted == expected


def test_training_counts_three_forwards():
    inputs = build_inputs(tiny_config("gt-o96-1024"), 3)
    shape = model_shape(inputs)
    assert y.training_flops(shape) == 3 * y.forward_flops(shape)


def test_graph_attention_sets_of_each_configuration():
    gt = model_shape(build_inputs(tiny_config("gt-o96-1024"), 3))
    tr = model_shape(build_inputs(tiny_config("transformer-o96-1024"), 3))
    assert len(gt.gt_sets()) == 2 + gt.layers and len(tr.gt_sets()) == 2
    assert gt.encoder.n_dst == gt.n_hidden and gt.decoder.n_dst == gt.n_data
