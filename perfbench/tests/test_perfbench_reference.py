"""The plain reference against the program at a tiny size on the CPU, and
whole runs of each cell at that size (the harness's look for a card left
out).  This test imports both; the reference itself imports nothing of the
program."""

from __future__ import annotations

import math
import time

import numpy as np
import pytest
import torch

from conftest import tiny_config

from perfbench.harness.cell import run_cell
from perfbench.harness.inputs import (
    build_inputs,
    draw_weights,
    load_weights,
    program_interface,
    reference_graph,
)
from perfbench.reference.encprocdec import Reference

CPU = torch.device("cpu")
CELLS = ["gt1024-train-b4", "transformer1024-train-b4", "gt1024-forecast-b1",
         "transformer1024-forecast-b1"]


@pytest.mark.parametrize("name", ["gt-o96-1024", "transformer-o96-1024"])
def test_forward_matches_the_program_in_float32(name):
    """One float32 forward of the program (master weights, plain attention on
    the CPU) and of the reference on the same weights and inputs."""
    inputs = build_inputs(tiny_config(name), 11)
    iface = program_interface(inputs, CPU, training=True)
    weights = draw_weights(inputs.shapes, 11, CPU)
    load_weights(iface.model, weights)
    g, v_in = inputs.num_nodes["data"], len(inputs.variables.input_idx)
    x = torch.randn(2, 2, 1, g, v_in, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        program = iface.run_model({"data": x})["data"][:, 0, 0]
        ref = Reference(inputs.config["model"], reference_graph(inputs, CPU), inputs.variables)
        reference = ref.forward(weights, x[:, :, 0])
    scale = reference.abs().max()
    assert float((program - reference).abs().max() / scale) < 2e-5


@pytest.mark.parametrize("name", ["gt-o96-1024", "transformer-o96-1024"])
def test_reference_works_out_the_graph_features(name):
    """The edge features and the area weights the reference works out from
    the node coordinates and the edges' endpoints are the program's graph
    builder's, to float32 rounding (the builder takes a set's standard
    deviation with its edges in another order)."""
    inputs = build_inputs(tiny_config(name), 1)
    ref, cfg = inputs.ref, inputs.config
    feats = ref.edge_features(cfg, inputs.arrays)
    for part, key in ref.PARTS.items():
        e = inputs.graph[key]
        program = np.concatenate([np.asarray(e.attributes[a], dtype=np.float32).reshape(
            e.edge_index.shape[1], -1) for a in ref.edge_attribute_names(cfg, part)], axis=1)
        np.testing.assert_allclose(feats[part], program, rtol=1e-6, atol=1e-12, err_msg=part)
    area = inputs.graph["data"].attributes[cfg["training"]["area_attribute"]]
    np.testing.assert_allclose(ref.area_weights(cfg, inputs.arrays),
                               np.asarray(area, dtype=np.float32).reshape(-1), rtol=1e-6)


def test_parameters_are_the_configurations():
    """The reference's parameter list is the program's, name for name and
    shape for shape (load_weights raises otherwise)."""
    inputs = build_inputs(tiny_config("gt-o96-1024"), 1)
    iface = program_interface(inputs, CPU, training=False)
    assert {k: tuple(p.shape) for k, p in iface.model.named_parameters()} == inputs.shapes


def test_same_seed_same_inputs():
    a = draw_weights(build_inputs(tiny_config("gt-o96-1024"), 2**31 + 5).shapes, 2**31 + 5, CPU)
    b = draw_weights(build_inputs(tiny_config("gt-o96-1024"), 2**31 + 5).shapes, 2**31 + 5, CPU)
    c = draw_weights(build_inputs(tiny_config("gt-o96-1024"), 7).shapes, 7, CPU)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not all(torch.equal(a[k], c[k]) for k in a)


def finite_checks(result):
    """Every compared number is there and finite.  (At the tiny size the
    program's readings are not held to the cell's limits, which were set
    from readings at the cell's own size on the card.)"""
    return result["checks"] and all(math.isfinite(c["value"]) and c["value"] >= 0
                                    for c in result["checks"].values())


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs(tiny_bench, workload):
    result = run_cell(tiny_bench, workload, 2**31 + 17, 0.5, False, CPU, time.perf_counter())
    assert finite_checks(result), result["checks"]
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert "setup_s" in result["metrics"]
    assert list(result)[-2:] == ["checks", "_notes"]


@pytest.mark.parametrize("workload", ["gt1024-train-b4", "transformer1024-forecast-b1"])
def test_traced_run_reads_its_metrics(tiny_bench, workload):
    result = run_cell(tiny_bench, workload, 5, 0.2, True, CPU, time.perf_counter())
    assert finite_checks(result)
    names = set(result["metrics"])
    assert {"mfu.train", "launches_per_sample.train"} <= names or {
        "mfu.forecast", "launches_per_state.forecast"} <= names
    assert "window_s" in result["device"] and "breakdown" in result
