"""Device ms a forecast state under the span anemoi.model.encoder (encoder)."""

from perfbench.harness.spans import span_ms


def read(trace, ctx):
    return span_ms(trace, ctx, "forecast", ("anemoi.model.encoder",), "unit")
