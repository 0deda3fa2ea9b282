"""Device ms a training step under the span anemoi.optim.clip: the gradients' clipping (optimizer)."""

from perfbench.harness.spans import span_ms


def read(trace, ctx):
    return span_ms(trace, ctx, "train", ("anemoi.optim.clip",), "step")
