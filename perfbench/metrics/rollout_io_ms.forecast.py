"""Device ms a forecast state under the spans anemoi.forecast.inputs, .cast, .output, .advance and .gather (entry)."""

from perfbench.harness.spans import span_ms


def read(trace, ctx):
    names = ("anemoi.forecast.inputs",
             "anemoi.forecast.cast",
             "anemoi.forecast.output",
             "anemoi.forecast.advance",
             "anemoi.forecast.gather")
    return span_ms(trace, ctx, "forecast", names, "unit")
