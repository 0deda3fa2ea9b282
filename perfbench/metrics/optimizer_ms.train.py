"""Device ms a training step of the kernels launched under torch.optim's AdamW step (optimizer)."""

from perfbench.harness.readers import optimizer_ms


def read(trace, ctx):
    return optimizer_ms(trace, ctx)
