"""The training step's model operations a second over the card's bf16 peak, in % (model step)."""

from perfbench.harness.readers import mfu


def read(trace, ctx):
    return mfu(trace, ctx, "train")
