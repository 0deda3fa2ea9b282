"""Device ms a training sample under the spans anemoi.model.encoder and anemoi.model.encoder.backward (encoder)."""

from perfbench.harness.spans import span_ms


def read(trace, ctx):
    names = ("anemoi.model.encoder",
             "anemoi.model.encoder.backward")
    return span_ms(trace, ctx, "train", names, "unit")
