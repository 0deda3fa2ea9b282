"""Device kernels launched in the profiled stretch a training sample (entry: training/step.py)."""

from perfbench.harness.readers import launches_per_unit


def read(trace, ctx):
    return launches_per_unit(trace, ctx, "train")
