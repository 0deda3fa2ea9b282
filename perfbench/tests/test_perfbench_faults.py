"""``correct`` must come out false when the timed path is broken
underneath: a whole run of a cell at the tiny size on the CPU with each
fault that the cell can have planted in the program (its graph builder's
edge features and area weights among them), judged by the full
configuration's limits.  One card a cell: no exchange between cards to
leave out.  And the control (float8 operands and states, the step below
the program's bf16) put in the program's place fails the same limits."""

from __future__ import annotations

import time

import pytest
import torch

from conftest import load, tiny_config

from perfbench.calibrate import control_numbers
from perfbench.harness.cell import run_cell

CPU = torch.device("cpu")


def run(bench, workload):
    return run_cell(bench, workload, 2**31 + 29, 0.3, False, CPU, time.perf_counter())


def state_unchanged(monkeypatch):
    from anemoi_tpu_torch.training.step import TrainState

    def apply_gradients(self):  # the update skipped: the state returned as it was
        self.step += 1
        return self

    monkeypatch.setattr(TrainState, "apply_gradients", apply_gradients)


def half_batch(monkeypatch):
    from anemoi_tpu_torch.models.interface import AnemoiModelInterface

    def local_rows(self, batch):  # half of the batch left out, the mean over the rest
        return {ds: b[: max(1, b.shape[0] // 2)] for ds, b in batch.items()}

    monkeypatch.setattr(AnemoiModelInterface, "local_rows", local_rows)


def forecast_state_unchanged(monkeypatch):
    import anemoi_tpu_torch.inference as inference

    monkeypatch.setattr(inference, "advance_input", lambda x, *args, **kw: x)


def forecast_answer_altered(monkeypatch):
    import anemoi_tpu_torch.inference as inference

    make = inference.make_forecast_fn

    def make_forecast_fn(interface, steps):
        fn = make(interface, steps)

        def altered(batch):  # the last lead time's answer read from the first step
            out = fn(batch)
            return {ds: torch.cat([y[:, :-1], y[:, :1]], dim=1) for ds, y in out.items()}

        return altered

    monkeypatch.setattr(inference, "make_forecast_fn", make_forecast_fn)


def _graph_altered(monkeypatch, alter):
    from anemoi_tpu_torch.graphs.create import GraphCreator

    create = GraphCreator.create

    def altered(self, *args, **kw):
        graph = create(self, *args, **kw)
        alter(graph)
        return graph

    monkeypatch.setattr(GraphCreator, "create", altered)


def edge_length_altered(monkeypatch):
    def alter(graph):  # the encoder's edge lengths a quarter too long
        e = graph[("data", "hidden")]
        e.attributes["edge_length"] = e.attributes["edge_length"] * 1.25

    _graph_altered(monkeypatch, alter)


def edge_direction_reversed(monkeypatch):
    def alter(graph):  # the encoder's edge directions the wrong way round
        e = graph[("data", "hidden")]
        e.attributes["edge_dirs"] = -e.attributes["edge_dirs"]

    _graph_altered(monkeypatch, alter)


def area_weights_altered(monkeypatch):
    def alter(graph):  # every data point weighted alike in the loss
        area = graph["data"].attributes["area_weight"]
        graph["data"].attributes["area_weight"] = area * 0 + 1

    _graph_altered(monkeypatch, alter)


TRAIN_FAULTS = [state_unchanged, half_batch, edge_length_altered, edge_direction_reversed,
                area_weights_altered]
# (a quarter too long an edge length reads 0.042 in a tiny forecast, under
# the limit: the training cells are the ones that see it)
FORECAST_FAULTS = [forecast_state_unchanged, forecast_answer_altered, edge_direction_reversed]


@pytest.mark.parametrize("fault", TRAIN_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", ["gt1024-train-b4", "transformer1024-train-b4"])
def test_training_fault_is_not_correct(tiny_bench, monkeypatch, workload, fault):
    fault(monkeypatch)
    result = run(tiny_bench, workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("fault", FORECAST_FAULTS, ids=lambda f: f.__name__)
@pytest.mark.parametrize("workload", ["gt1024-forecast-b1", "transformer1024-forecast-b1"])
def test_forecast_fault_is_not_correct(tiny_bench, monkeypatch, workload, fault):
    fault(monkeypatch)
    result = run(tiny_bench, workload)
    assert not result["correct"], result["checks"]


@pytest.mark.parametrize("traffic", ["train_closed", "forecast_closed"])
@pytest.mark.parametrize("name", ["gt-o96-1024", "transformer-o96-1024"])
def test_control_is_not_correct(name, traffic):
    config = tiny_config(name)
    mix = load(f"perfbench/traffic/{traffic}.json")
    numbers = control_numbers(config, mix, 2**31 + 41, CPU)
    limits = config["limits"][mix["driver"]]
    assert any(numbers[k] > limits[k] for k in numbers), (numbers, limits)
