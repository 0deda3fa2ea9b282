"""Share of the untraced training window in which the device runs nothing, in % (device)."""

from perfbench.harness.readers import device_idle


def read(trace, ctx):
    return device_idle(trace, ctx, "train")
