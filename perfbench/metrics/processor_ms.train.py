"""Device ms a training sample under the spans anemoi.model.processor and anemoi.model.processor.backward, block recomputes included (processor)."""

from perfbench.harness.spans import span_ms


def read(trace, ctx):
    names = ("anemoi.model.processor",
             "anemoi.model.processor.backward")
    return span_ms(trace, ctx, "train", names, "unit")
