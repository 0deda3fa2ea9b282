"""Kernels a training step launched under the spans anemoi.step.grad_norm, anemoi.optim.clip and anemoi.optim.update (optimizer)."""

from perfbench.harness.spans import span_launches


def read(trace, ctx):
    names = ("anemoi.step.grad_norm",
             "anemoi.optim.clip",
             "anemoi.optim.update")
    return span_launches(trace, ctx, "train", names)
