"""Device ms a training sample under the spans anemoi.model.decoder and anemoi.model.decoder.backward (decoder)."""

from perfbench.harness.spans import span_ms


def read(trace, ctx):
    names = ("anemoi.model.decoder",
             "anemoi.model.decoder.backward")
    return span_ms(trace, ctx, "train", names, "unit")
