"""The readers of the program's spans (``harness/spans.py`` and the
``program_span`` metrics) on synthetic Chrome-trace events: a kernel counts
once however its spans nest or are entered again, launches from a second
thread are attributed by time, the components never share a kernel, and
a reader returns None where its spans never ran or the trace has no
kernel (a run on the CPU, or a program without the spans)."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench.harness import cell as harness
from perfbench.harness import spans
from perfbench.harness.cell import run_cell
from perfbench.harness.readers import ReadContext
from perfbench.harness.trace import Trace

MAIN, AUTOGRAD = 1, 2
TRAIN = ReadContext("train", units=4, steps=2, evaluations=2, batch=2, elt=2, shape=None,
                    window_rate=10.0, unit_flops=1.0)
FORECAST = ReadContext("forecast", units=4, steps=1, evaluations=4, batch=1, elt=2, shape=None,
                       window_rate=10.0, unit_flops=1.0)


def span(name, ts, dur, tid=MAIN):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur, "tid": tid,
            "args": {}}


def launch(corr, ts, dur_us, tid=MAIN, name="k"):
    """A launch at ``ts`` on the host and its kernel of ``dur_us`` on the device."""
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts, "dur": 2,
             "tid": tid, "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": name, "ts": 1000 + ts, "dur": dur_us,
             "args": {"correlation": corr}}]


def training_step_events():
    """One step: the forward on the main thread, the backward's component
    spans on the autograd thread (the decoder's holding a rollout
    recompute that enters the encoder's forward span, nested in itself),
    the tail on the main thread."""
    ev = [span("anemoi.step.cast", 0, 10), span("anemoi.step.forward", 10, 90),
          span("anemoi.model.encoder", 20, 20), span("anemoi.model.processor", 40, 30),
          span("anemoi.model.decoder", 70, 20), span("anemoi.step.backward", 100, 200),
          span("anemoi.model.decoder.backward", 110, 60, AUTOGRAD),
          span("anemoi.model.encoder", 120, 20, AUTOGRAD),
          span("anemoi.model.encoder", 125, 10, AUTOGRAD),
          span("anemoi.model.processor.backward", 170, 80, AUTOGRAD),
          span("anemoi.model.encoder.backward", 250, 40, AUTOGRAD),
          span("anemoi.step.grad_norm", 300, 10), span("anemoi.optim.clip", 310, 10),
          span("anemoi.optim.update", 320, 30), span("Optimizer.step#AdamW.step", 325, 20)]
    for corr, ts, us, tid in [(1, 5, 100, MAIN),  # cast
                              (2, 25, 200, MAIN), (3, 45, 300, MAIN), (4, 75, 400, MAIN),
                              (5, 115, 500, AUTOGRAD),  # decoder backward
                              (6, 130, 600, AUTOGRAD),  # the recompute, nested encoder spans
                              (7, 200, 700, AUTOGRAD), (8, 260, 800, AUTOGRAD),
                              (9, 295, 900, AUTOGRAD),  # after the components: step.backward
                              (10, 305, 10, MAIN), (11, 315, 20, MAIN), (12, 330, 30, MAIN),
                              (13, 340, 40, MAIN),
                              (14, 360, 1000, MAIN)]:  # outside every anemoi. span
        ev += launch(corr, ts, us, tid)
    return ev


def training_step():
    return Trace(training_step_events(), 1.0)


def test_a_kernel_counts_once_in_its_innermost_span():
    t = training_step()

    def us(names):
        return sum(k.dur for k in spans.kernels_under(t, names))

    assert us(["anemoi.model.encoder"]) == 200 + 600
    assert us(["anemoi.model.decoder.backward"]) == 500
    assert us(["anemoi.model.encoder", "anemoi.model.encoder.backward",
               "anemoi.step.backward"]) == 200 + 600 + 800 + 900
    assert len(spans.kernels_under(t, ["anemoi.model.encoder"])) == 2


def test_launches_of_a_second_thread_are_attributed_by_time():
    """The autograd thread's launch after its component spans closed falls
    in the main thread's ``anemoi.step.backward``."""
    t = training_step()
    assert spans.owners(t)[9] == "anemoi.step.backward"
    assert spans.owners(t)[7] == "anemoi.model.processor.backward"


def test_the_readers_of_a_training_step():
    t = training_step()
    read = {m: harness.reader(m)(t, TRAIN) for m in (
        "encoder_ms.train", "processor_ms.train", "decoder_ms.train", "cast_ms.train",
        "clip_ms.train", "tail_launches.train")}
    assert read["encoder_ms.train"] == pytest.approx((200 + 600 + 800) / 1e3 / 4)
    assert read["processor_ms.train"] == pytest.approx((300 + 700) / 1e3 / 4)
    assert read["decoder_ms.train"] == pytest.approx((400 + 500) / 1e3 / 4)
    assert read["cast_ms.train"] == pytest.approx(100 / 1e3 / 2)
    assert read["clip_ms.train"] == pytest.approx(20 / 1e3 / 2)
    assert read["tail_launches.train"] == 4 / 2
    total_ms = sum(k.dur for k in t.kernels) / 1e3 / TRAIN.units
    parts = read["encoder_ms.train"] + read["processor_ms.train"] + read["decoder_ms.train"]
    assert parts < total_ms
    assert spans.covered_share(t) == pytest.approx(100 * (1 - 1000 / 5600))
    # a forecast reader reads nothing of a training stretch
    assert harness.reader("encoder_ms.forecast")(t, TRAIN) is None


def test_the_readers_of_a_forecast():
    ev = [span("anemoi.forecast.inputs", 0, 10), span("anemoi.forecast.cast", 10, 10)]
    corr = 1
    ev += launch(corr, 5, 10) + launch(corr + 1, 15, 20)
    corr = 3
    for step in range(4):
        at = 20 + 100 * step
        ev += [span("anemoi.forecast.model", at, 60), span("anemoi.model.encoder", at + 5, 15),
               span("anemoi.model.processor", at + 20, 20),
               span("anemoi.model.decoder", at + 40, 15),
               span("anemoi.forecast.output", at + 60, 10),
               span("anemoi.forecast.advance", at + 70, 10)]
        for offset, us in ((10, 100), (30, 300), (45, 200), (50, 0), (65, 5), (75, 5)):
            ev += launch(corr, at + offset, us)
            corr += 1
    ev += [span("anemoi.forecast.gather", 420, 10)] + launch(corr, 425, 40)
    t = Trace(ev, 1.0)
    got = {m: harness.reader(m)(t, FORECAST) for m in (
        "encoder_ms.forecast", "processor_ms.forecast", "decoder_ms.forecast",
        "rollout_io_ms.forecast")}
    assert got == pytest.approx({"encoder_ms.forecast": 0.1, "processor_ms.forecast": 0.3,
                                 "decoder_ms.forecast": 0.2,
                                 "rollout_io_ms.forecast": (30 + 40 + 4 * 10) / 1e3 / 4})


@pytest.mark.parametrize("metric", ["encoder_ms.train", "cast_ms.train", "clip_ms.train",
                                    "tail_launches.train"])
def test_a_reader_returns_none_where_its_spans_never_ran(metric):
    """A program without the spans: the kernels are there, no span is."""
    ev = launch(1, 5, 100) + [span("perfbench.train_step", 0, 20)]
    assert harness.reader(metric)(Trace(ev, 1.0), TRAIN) is None


def test_a_reader_returns_none_without_kernels():
    """A run on the CPU: the spans ran, the device ran nothing."""
    ev = [e for e in training_step_events() if e["cat"] == "user_annotation"]
    t = Trace(ev, 1.0)
    assert harness.reader("processor_ms.train")(t, TRAIN) is None
    assert harness.reader("tail_launches.train")(t, TRAIN) is None
    assert spans.covered_share(t) is None


def test_the_span_metrics_are_entries_of_the_benchmark(bench):
    names = {"encoder_ms.train", "processor_ms.train", "decoder_ms.train", "cast_ms.train",
             "clip_ms.train", "tail_launches.train", "encoder_ms.forecast",
             "processor_ms.forecast", "decoder_ms.forecast", "rollout_io_ms.forecast"}
    got = {m["name"]: m for m in bench["per_layer"] if m["source"] == "program_span"}
    assert set(got) == names
    for name, m in got.items():
        kind = name.rsplit(".", 1)[1]
        assert all(w.split("-")[1] == kind for w in m["workloads"]), name
        assert len(m["workloads"]) == 2


def test_a_traced_cpu_run_leaves_the_span_metrics_out(tiny_bench):
    result = run_cell(tiny_bench, "gt1024-train-b4", 5, 0.2, True, torch.device("cpu"),
                      time.perf_counter())
    assert not any(n.endswith(("_ms.train", "launches.train")) and n != "optimizer_ms.train"
                   for n in result["metrics"])
