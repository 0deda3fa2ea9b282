"""Device ms a training step under the span anemoi.step.cast: the compute copies of the masters (entry)."""

from perfbench.harness.spans import span_ms


def read(trace, ctx):
    return span_ms(trace, ctx, "train", ("anemoi.step.cast",), "step")
