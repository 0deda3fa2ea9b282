"""The port's spans (``anemoi_tpu_torch/utils/tracing.py``) on the CPU.

A tiny flagship (o16 -> ico-2, 32 channels, 2 GraphTransformer processor
layers with per-layer checkpoints, 4 heads) and a tiny ``transformer``
preset (2 band layers, window 16) train one bf16 step on float32 masters
and serve a 2-step bf16 forecast under ``torch.profiler``:

- every span of the step, the optimizer, the forecast loop and the model is
  in the trace, nested as ``utils/tracing.py`` lists them (the phases inside
  ``anemoi.step`` and ``anemoi.forecast``); the components'
  backward spans all close, lie inside ``anemoi.step.backward`` and follow
  one another (decoder, processor, encoder); a rollout-2 step under rollout
  remat enters the model's forward spans again inside the backward;
- the phases' spans cover the step's host time, and the forecast's;
- with the profiler off no ``record_function`` is entered and the loss's
  autograd graph has as many nodes as with the model's components called
  plainly; with it on, the losses, gradients, updated weights and forecasts
  are bitwise those of a run with it off;
- ``BenchmarkProfiler.section`` emits ``anemoi.profile.<name>``; the
  trainer's wait for a batch is the span ``anemoi.trainer.data_wait``.
"""

import json

import numpy as np
import pytest
import torch

from anemoi_tpu_torch.flagship import (
    VARIABLES,
    example_o96_gt_config,
    flagship_config,
    flagship_indices,
    flagship_recipe,
    flagship_statistics,
    transformer_config,
)
from anemoi_tpu_torch.graphs.create import GraphCreator
from anemoi_tpu_torch.inference import make_forecast_fn
from anemoi_tpu_torch.models import encoder_processor_decoder as encprocdec
from anemoi_tpu_torch.models.interface import AnemoiModelInterface
from anemoi_tpu_torch.training.losses import get_loss_function
from anemoi_tpu_torch.training.losses.scalers import create_scalers
from anemoi_tpu_torch.training.optimizers import build_optimizer
from anemoi_tpu_torch.training.profiler import BenchmarkProfiler
from anemoi_tpu_torch.training.step import TrainState, make_step_fns
from anemoi_tpu_torch.training.trainer import AnemoiTrainer
from anemoi_tpu_torch.utils import tracing
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

SCALERS = {"area": {"name": "GraphNodeAttributeScaler", "nodes_name": "data",
                    "attribute_name": "area_weight"}}
LOSS = {"name": "WeightedMSELoss", "scalers": ["area"]}
OPT = {"optimizer": {"name": "adamw"}, "lr": {"rate": 1e-3}, "gradient_clip": {"val": 1e-3}}
PARTS = ("encoder", "processor", "decoder")
STEP = ("anemoi.step.cast", "anemoi.step.inputs", "anemoi.step.forward", "anemoi.step.loss",
        "anemoi.step.backward", "anemoi.step.grad_reduce", "anemoi.step.grad_norm",
        "anemoi.optim.clip", "anemoi.optim.update")
FORECAST = ("anemoi.forecast.inputs", "anemoi.forecast.cast", "anemoi.forecast.model",
            "anemoi.forecast.output", "anemoi.forecast.advance", "anemoi.forecast.gather")


@pytest.fixture(scope="module")
def graph():
    return GraphCreator(flagship_recipe("o16", 2)).create()


def model_config(kind: str) -> dict:
    if kind == "gt":
        cfg = flagship_config(num_channels=32, num_layers=2, num_heads=4)
        cfg["model"]["processor"]["gradient_checkpointing"] = True
    else:
        cfg = transformer_config(num_channels=32, num_layers=2, num_heads=4, window_size=16)
    cfg["model"]["graph_attention_backend"] = "segment"
    return cfg


def setup(graph, kind: str, rollout: int = 1, loss_seen=None):
    """A fresh interface with seeded float32 masters, its bf16 train step
    and optimizer state, and a seeded batch of 2 samples."""
    stats = flagship_statistics(1)
    iface = AnemoiModelInterface(config=model_config(kind), graph=graph,
                                 data_indices=flagship_indices(), statistics=stats,
                                 device="cpu", training=True)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        for p in iface.parameters():
            p.copy_(0.3 * torch.randn(p.shape, generator=gen))
    loss = get_loss_function(LOSS, create_scalers(SCALERS, graph=graph))
    if loss_seen is not None:
        def seen(pred, target, mask=None):
            out = loss(pred, target, mask=mask)
            loss_seen.append(out)
            return out
    train_step, _ = make_step_fns(iface, {"data": loss if loss_seen is None else seen},
                                  rollout=rollout, precision="bf16")
    state = TrainState.create(iface, build_optimizer(OPT))
    rng = np.random.default_rng(0)
    mean, std = stats["data"]["mean"], stats["data"]["stdev"]
    n = graph["data"].num_nodes
    batch = (mean + std * rng.normal(size=(2, 2 + rollout, 1, n, len(VARIABLES))))
    return iface, state, train_step, {"data": torch.from_numpy(batch.astype(np.float32))}


def window(batch):
    """A 2-step forecast's window [1, 4, ...] from the batch's first sample."""
    first = batch["data"][:1, :2]
    return {"data": torch.cat([first, first], dim=1)}


def annotations(prof, tmp_path):
    """The trace's user annotations: (name, start, end, event) in µs."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"], e) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"]


def named(spans, name):
    return [s for s in spans if s[0] == name]


def inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def covered(spans, whole) -> float:
    """The share of ``whole``'s interval that the union of ``spans`` covers."""
    cuts = sorted((max(a, whole[1]), min(b, whole[2])) for _, a, b, _ in spans)
    total, end = 0.0, whole[1]
    for a, b in cuts:
        if b > end:
            total += b - max(a, end)
            end = b
    return total / (whole[2] - whole[1])


def traced(graph, tmp_path, kind, rollout=1):
    """One train step and one forecast (a warm step first) under the profiler."""
    iface, state, train_step, batch = setup(graph, kind, rollout)
    train_step(state, batch)
    forecast = make_forecast_fn(iface, steps=2)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with torch.profiler.record_function("test.train_step"):
            train_step(state, batch)
        with torch.profiler.record_function("test.forecast"):
            forecast(window(batch))
    return annotations(prof, tmp_path)


@pytest.mark.parametrize("kind", ["gt", "transformer"])
def test_a_step_and_a_forecast_emit_every_span_nested(graph, tmp_path, kind):
    spans = traced(graph, tmp_path, kind)
    (outer,), (whole,) = named(spans, "anemoi.step"), named(spans, "anemoi.forecast")
    (step,), (fc,) = named(spans, "test.train_step"), named(spans, "test.forecast")
    assert inside(outer, step) and inside(whole, fc)
    step, fc = outer, whole
    for name in STEP:
        assert named(spans, name), name
        assert all(inside(s, step) for s in named(spans, name)), name
    forward, (backward,) = named(spans, "anemoi.step.forward"), named(spans, "anemoi.step.backward")
    (update,) = named(spans, "anemoi.optim.update")
    assert all(inside(s, update) for s in named(spans, "Optimizer.step#AdamW.step"))
    ends = []
    for part in PARTS:
        fwd = [s for s in named(spans, f"anemoi.model.{part}") if inside(s, step)]
        assert len(fwd) == 1 and inside(fwd[0], forward[0]), part
        (bwd,) = named(spans, f"anemoi.model.{part}.backward")
        assert bwd[3]["args"].get("finished") is not False, part
        assert inside(bwd, backward), part
        ends.append((bwd[1], bwd[2]))
    # the backward runs decoder, processor, encoder, one after the other
    (e0, e1), (p0, p1), (d0, d1) = ends
    assert d1 <= p0 and p1 <= e0
    for name in FORECAST:
        assert named(spans, name) and all(inside(s, fc) for s in named(spans, name)), name
    models = named(spans, "anemoi.forecast.model")
    assert len(models) == 2
    for part in PARTS:
        runs = [s for s in named(spans, f"anemoi.model.{part}") if inside(s, fc)]
        assert len(runs) == 2 and all(any(inside(s, m) for m in models) for s in runs), part
    top = [s for s in spans if s[0] in STEP[:-2]]
    assert covered(top + named(spans, "anemoi.optim.clip") + [update], step) > 0.95
    assert covered([s for s in spans if s[0] in FORECAST], fc) > 0.95


def test_rollout_remat_enters_the_forward_spans_again_in_the_backward(graph, tmp_path):
    spans = traced(graph, tmp_path, "gt", rollout=2)
    (step,) = named(spans, "test.train_step")
    (backward,) = named(spans, "anemoi.step.backward")
    for part in PARTS:
        fwd = [s for s in named(spans, f"anemoi.model.{part}") if inside(s, step)]
        # two rollout steps, each recomputed once in the backward
        assert len(fwd) == 4 and sum(inside(s, backward) for s in fwd) == 2, part
        bwd = named(spans, f"anemoi.model.{part}.backward")
        assert len(bwd) == 2 and all(inside(s, backward) for s in bwd), part
        assert all(s[3]["args"].get("finished") is not False for s in bwd), part


def graph_size(root) -> int:
    seen, todo = set(), [root]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(n for n, _ in node.next_functions)
    return len(seen)


@pytest.mark.parametrize("kind", ["gt", "transformer"])
def test_the_profiler_off_adds_no_node_nor_record(graph, kind, monkeypatch):
    entered = []
    original = torch.profiler.record_function

    def counted(*args, **kwargs):
        entered.append(args[0])
        return original(*args, **kwargs)

    def nodes(plain=False, profile=False):
        seen = []
        iface, state, train_step, batch = setup(graph, kind, loss_seen=seen)
        with monkeypatch.context() as m:
            if plain:
                m.setattr(encprocdec, "components", lambda: tracing.plain)
            if profile:
                with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                    train_step(state, batch)
            else:
                train_step(state, batch)
        return graph_size(seen[0].grad_fn)

    monkeypatch.setattr(torch.profiler, "record_function", counted)
    off = nodes()
    assert entered == []
    iface, _, _, batch = setup(graph, kind)
    make_forecast_fn(iface, steps=2)(window(batch))
    assert entered == []
    assert off == nodes(plain=True)
    # on: hooks, no node
    assert nodes(profile=True) == off and entered


@pytest.mark.parametrize("kind", ["gt", "transformer"])
def test_the_profiler_changes_no_bit(graph, kind):
    def run(profile):
        iface, state, train_step, batch = setup(graph, kind)
        forecast = make_forecast_fn(iface, steps=2)
        out = {}

        def body():
            _, met = train_step(state, batch)
            out["loss"], out["grad_norm"] = met["loss"], met["grad_norm"]
            out["grads"] = {n: p.grad.clone() for n, p in iface.named_parameters()}
            out["weights"] = {n: p.detach().clone() for n, p in iface.named_parameters()}
            out["forecast"] = forecast(window(batch))["data"]

        if profile:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
                body()
        else:
            body()
        return out

    off, on = run(False), run(True)
    assert torch.equal(off["loss"], on["loss"]) and torch.equal(off["grad_norm"], on["grad_norm"])
    for n in off["grads"]:
        assert torch.equal(off["grads"][n], on["grads"][n]), n
        assert torch.equal(off["weights"][n], on["weights"][n]), n
    assert torch.equal(off["forecast"], on["forecast"])


def test_span_is_a_shared_null_context_with_the_profiler_off():
    assert tracing.span("anemoi.x") is tracing.span("anemoi.y", {"step": 1})
    assert tracing.components() is tracing.plain
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(tracing.span("anemoi.x"), torch.profiler.record_function)
        assert tracing.components() is not tracing.plain


def test_benchmark_profiler_sections_are_spans(tmp_path):
    prof = BenchmarkProfiler(str(tmp_path / "out"))
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as p:
        with prof.section("dataloader"):
            torch.ones(3).sum()
    spans = annotations(p, tmp_path)
    assert [s[0] for s in spans] == ["anemoi.profile.dataloader"]
    assert len(prof.section_times["dataloader"]) == 1


def test_the_trainer_waits_for_a_batch_in_a_span(tmp_path):
    cfg = example_o96_gt_config(num_channels=16, num_layers=1, precision="fp32", grid="o8",
                                mesh_resolution=1, num_times=24)
    cfg["model"]["graph_attention_backend"] = "segment"
    cfg["model"]["inference_precision"] = "fp32"
    cfg["graph"]["save_path"] = str(tmp_path / "graph.npz")
    cfg["hardware"] = {"platform": "cpu", "num_devices": 1}
    cfg["dataloader"]["batch_size"] = 2
    cfg["training"].update(max_epochs=1, max_steps=2)
    cfg["output_dir"] = str(tmp_path / "run")
    trainer = AnemoiTrainer(cfg, output_dir=cfg["output_dir"])
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        trainer.train()
    spans = annotations(prof, tmp_path)
    waits, forwards = named(spans, "anemoi.trainer.data_wait"), named(spans, "anemoi.step.forward")
    # the two training steps, each after its wait; then the validation's forward
    assert len(waits) == 2 and len(forwards) == 3
    assert all(w[2] <= f[1] for w, f in zip(waits, forwards))
    assert not hasattr(trainer, "data_wait_s")
